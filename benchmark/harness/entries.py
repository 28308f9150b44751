"""The entry loops that drive the program through a window, by the name a
traffic mix gives in ``entry``:

- ``pipelined``: all-intra frames through ``SliceEncoder``, as ``bench.py``
  drives the JAX package: ``workers`` host threads, each with its own
  ``SliceEncoder``, take every ``workers``-th frame, send ``batch`` frames
  at a time through ``dispatch_frames_search`` one batch ahead, and
  finalize each with ``encode_frame(prefetch=)``.
- ``stream``: one closed-loop stream through ``Encoder.feed/flush``: the
  next frame is fed when ``feed`` returns; ``warm_frames`` frames are fed
  in set-up, so that the window meets a full pipeline.

Each loop records when each frame was first called and when its access
unit came back, the spans of its calls, and for the frames drawn for the
check the search decisions that the program hands from its device search
to its host back end. The ``stream`` loop also keeps, for the check, what
the low-delay P frame's inter stages were given and gave back: the host
full-pel motion search and K8's leaf refinement of each drawn frame, and
a sample of the rdoq calls drawn from the seed.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .clip import order


class Run:
    """What a window left: frames, spans, captured decisions."""

    def __init__(self):
        self.t_start = 0.0          # the window's start (perf_counter)
        self.t_end = 0.0            # its close
        self.t_stop = 0.0           # the last frame started in it is done
        self.first = {}             # frame -> its first call
        self.done = {}              # frame -> its access unit returned
        self.in_window = set()      # frames first called in the window
        self.aus = None             # frame -> access unit, when kept
        self.spans = []             # (name, t0, t1)
        self.captured = {}          # frame -> the program's decisions
        # what the inter stages saw and gave: {"me": {frame: ...},
        # "qpel": {frame: ...}, "rdoq": [...]}
        self.stages = {"me": {}, "qpel": {}, "rdoq": []}
        self.source = {}            # frame -> pool index of its source
        self.launches = 0
        self.trace = None
        self.setup_s = 0.0
        self.lock = threading.Lock()

    def span(self, name, t0, t1):
        with self.lock:
            self.spans.append((name, t0, t1))

    def completed_in_window(self) -> list:
        return sorted(t for t in self.done.values() if t <= self.t_end)


def tree(node):
    """A program CTU node as the reference's nested tuples."""
    if node.children:
        return ("split", node.x, node.y, node.w,
                [tree(c) for c in node.children])
    return ("leaf", node.x, node.y, node.w, int(node.cu_desc["mode"]))


class Pipelined:
    """All-intra frames, batched and dispatched one batch ahead."""

    def __init__(self, cfg, traffic, pool, device, want, seed=0):
        from uvg266_tpu_torch.control.encoder import SliceEncoder
        from uvg266_tpu_torch.control.params import EncoderControl
        self.pool = pool
        self.qp = int(traffic["qp"])
        self.workers = int(traffic["workers"])
        self.batch = int(traffic["batch"])
        self.how = traffic.get("order", "cycle")
        self.want = want
        ctrl = EncoderControl(cfg)
        self.encs = [SliceEncoder(cfg, ctrl, device=device)
                     for _ in range(self.workers)]

    def _planes(self, g):
        from uvg266_tpu_torch.control.encoder import FramePlanes
        return FramePlanes(*self.pool[order(g, len(self.pool), self.how)])

    def _state(self, g):
        from uvg266_tpu_torch.control.params import FrameState
        return FrameState(num=g, qp=self.qp)

    def warm(self) -> None:
        """One batch through each worker's encoder: the batch shape the
        window uses, the tables of its QP, every kernel it launches."""
        for e in self.encs:
            idx = list(range(self.batch))
            rs = e.dispatch_frames_search([self._state(g) for g in idx],
                                          [self._planes(g) for g in idx])
            for g, r in zip(idx, rs):
                e.encode_frame(self._state(g), self._planes(g), prefetch=r)

    def window(self, run: Run) -> None:
        errors = []

        def work(slot):
            try:
                self._worker(slot, run)
            except Exception as exc:          # re-raised on the main thread
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _worker(self, slot: int, run: Run) -> None:
        e = self.encs[slot]

        def frames_of(b):
            return [slot + self.workers * (b * self.batch + j)
                    for j in range(self.batch)]

        def dispatch(b):
            idx = frames_of(b)
            t0 = time.perf_counter()
            with run.lock:
                for g in idx:
                    run.first[g] = t0
                    if t0 < run.t_end:
                        run.in_window.add(g)
                    run.source[g] = order(g, len(self.pool), self.how)
            rs = e.dispatch_frames_search([self._state(g) for g in idx],
                                          [self._planes(g) for g in idx])
            run.span("dispatch", t0, time.perf_counter())
            return [self._capture(g, r, run) for g, r in zip(idx, rs)]

        b = 0
        pre = dispatch(b)
        while pre is not None:
            nxt = dispatch(b + 1) if time.perf_counter() < run.t_end else None
            for g, r in zip(frames_of(b), pre):
                t0 = time.perf_counter()
                au, _rec = e.encode_frame(self._state(g), self._planes(g),
                                          prefetch=r)
                t1 = time.perf_counter()
                run.span("encode_frame", t0, t1)
                with run.lock:
                    run.done[g] = t1
                    if run.aus is not None:
                        run.aus[g] = bytes(au)
            pre = nxt
            b += 1

    def _capture(self, g, resolve, run: Run):
        if g not in self.want:
            return resolve

        def wrapped():
            ctus = resolve()
            run.captured[g] = ctus
            return ctus
        return wrapped

    def decisions(self, run: Run) -> dict:
        return {g: ("tree", [tree(n) for n in ctus])
                for g, ctus in run.captured.items()}

    def close(self) -> None:
        self.encs = []


class Stream:
    """One closed-loop stream through Encoder.feed/flush."""

    def __init__(self, cfg, traffic, pool, device, want, seed=0):
        from uvg266_tpu_torch.control.encoder import Encoder
        self.pool = pool
        self.how = traffic.get("order", "pingpong")
        self.warm_frames = int(traffic["warm_frames"])
        self.want = want
        self.enc = Encoder(cfg, device=device)
        self.next = 0
        self._patched = []
        self._wrap_screen()
        self._wrap_inter(traffic, seed)

    def _wrap_screen(self):
        """Keep, for the frames drawn for the check, the P-frame intra
        screen's result that the search hands to the host: every block's
        decision and RD cost."""
        se = self.enc.slice_enc
        orig = se.predispatch_intra_screen
        self._run = None

        def screen(fs, src_planes):
            tok = orig(fs, src_planes)
            run = self._run
            if tok is not None and run is not None and fs.num in self.want:
                fetch = tok["fetch"]

                def captured(fetch=fetch, g=fs.num):
                    flat = fetch()
                    run.captured[g] = np.array(flat, copy=True)
                    return flat
                tok["fetch"] = captured
            return tok
        se.predispatch_intra_screen = screen

    def _wrap_inter(self, traffic, seed):
        """Keep what the inter stages of a P frame were given and gave
        back: the host full-pel search (native ``me_frame_native``: the
        source and reference planes, the class grids, each block's
        vectors and costs) and K8's refinement (each inter leaf, its
        reference plane and full-pel vector, K8's 49 sums, the vector the
        caller kept) of the drawn frames; and the rdoq calls whose index
        in the window a generator seeded from the run draws, about one in
        ``rdoq_every``, at most ``rdoq_calls``."""
        import uvg266_tpu_torch.native as nat
        import uvg266_tpu_torch.ops.me_frame as mf
        import uvg266_tpu_torch.ops.rdoq as rq
        from uvg266_tpu_torch.consts import SliceType
        se = self.enc.slice_enc
        cur = {"me": None, "qpel": None}
        every = int(traffic.get("rdoq_every", 0))
        picks = set()
        if every:
            rng = np.random.default_rng([int(seed), 7])
            gaps = rng.integers(1, 2 * every, size=int(traffic["rdoq_calls"]))
            picks = set((np.cumsum(gaps) - 1).tolist())
        count = [0]
        lock = threading.Lock()

        def drawn(fs):
            return self._run is not None and fs.num in self.want

        orig_hostme = se._dispatch_inter_frame_hostme

        def hostme(ps, src_y, rl, fs, pretoken=None):
            cur["me"] = fs.num if drawn(fs) else None
            try:
                return orig_hostme(ps, src_y, rl, fs, pretoken=pretoken)
            finally:
                cur["me"] = None

        orig_me = nat.me_frame_native

        def me(src_y, uniq, prev_motion, *args, **kw):
            mvs, costs = orig_me(src_y, uniq, prev_motion, *args, **kw)
            g = cur["me"]
            if g is not None:
                self._run.stages["me"][g] = {
                    "refs": [np.array(p.y, copy=True) for _k, p in uniq],
                    "descs": [tuple(int(v) for v in d) for d in
                              (args[5] if len(args) > 5
                               else kw["class_descs"])],
                    "mvs": np.array(mvs, copy=True),
                    "costs": np.array(costs, copy=True)}
            return mvs, costs

        orig_refine = se._refine_inter_leaves

        def refine(ctus, uniq, refmap, l1_index, src_y, fs):
            if not drawn(fs):
                return orig_refine(ctus, uniq, refmap, l1_index, src_y, fs)
            is_b = fs.slicetype == SliceType.B
            cands, keep = [], []        # as the caller lists them for K8
            for node in ctus:
                for leaf in node.leaves():
                    d = leaf.cu_desc
                    if d.get("type") != "inter":
                        continue
                    if is_b and "_l0" in d:
                        for u, mv in (d["_l0"], d["_l1"]):
                            cands.append((leaf.x, leaf.y, leaf.w, leaf.h,
                                          int(u), tuple(mv)))
                            keep.append(None)
                    else:
                        cands.append((leaf.x, leaf.y, leaf.w, leaf.h,
                                      int(d["_u"]), tuple(d["mv"])))
                        keep.append(leaf)
            rec = {"cands": cands, "seg": None,
                   "refs": [np.array(p.y, copy=True) for _k, p in uniq]}
            cur["qpel"] = rec
            try:
                out = orig_refine(ctus, uniq, refmap, l1_index, src_y, fs)
            finally:
                cur["qpel"] = None
            rec["mv_out"] = [None if leaf is None
                             or leaf.cu_desc.get("type") != "inter"
                             else tuple(leaf.cu_desc["mv"]) for leaf in keep]
            self._run.stages["qpel"][fs.num] = rec
            return out

        orig_qpel = mf.leaf_qpel

        def qpel(windows, blocks, leaf_ids, n_leaves, pen, *args, **kw):
            out = orig_qpel(windows, blocks, leaf_ids, n_leaves, pen,
                            *args, **kw)
            rec = cur["qpel"]
            if rec is not None:
                rec["seg"] = out[2].detach().cpu().numpy().astype(np.float64)
            return out

        orig_rdoq = rq.rdoq_levels

        def rdoq(coef, qp_scaled, bitdepth, lam, *args, **kw):
            out = orig_rdoq(coef, qp_scaled, bitdepth, lam, *args, **kw)
            if self._run is not None and picks:
                with lock:
                    n = count[0]
                    count[0] += 1
                    if n in picks:
                        intra = args[0] if args else \
                            kw.get("is_intra_slice", True)
                        self._run.stages["rdoq"].append(
                            (np.array(coef, copy=True), int(qp_scaled),
                             int(bitdepth), float(lam), bool(intra),
                             np.array(out, copy=True)))
            return out

        se._dispatch_inter_frame_hostme = hostme
        se._refine_inter_leaves = refine
        for mod, name, fn in ((nat, "me_frame_native", me),
                              (mf, "leaf_qpel", qpel),
                              (rq, "rdoq_levels", rdoq)):
            self._patched.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def _planes(self, i):
        from uvg266_tpu_torch.control.encoder import FramePlanes
        return FramePlanes(*self.pool[order(i, len(self.pool), self.how)])

    def _feed(self, run: Run | None):
        i = self.next
        self.next += 1
        t0 = time.perf_counter()
        if run is not None:
            run.first[i] = t0
            run.in_window.add(i)
            run.source[i] = order(i, len(self.pool), self.how)
        outs = self.enc.feed(self._planes(i))
        t1 = time.perf_counter()
        if run is not None:
            run.span("feed", t0, t1)
            self._done(outs, t1, run)

    def _done(self, outs, t, run):
        for au, _rec, fs, _refs, _src in outs:
            run.done[fs.num] = t
            if run.aus is not None:
                run.aus[fs.num] = bytes(au)

    def warm(self) -> None:
        """The I frame and the first P frames, so that the window meets the
        two-frames-in-flight pipeline full."""
        for _ in range(self.warm_frames):
            self._feed(None)

    def window(self, run: Run) -> None:
        self._run = run
        while time.perf_counter() < run.t_end:
            self._feed(run)
        t0 = time.perf_counter()
        outs = self.enc.flush()
        t1 = time.perf_counter()
        run.span("flush", t0, t1)
        self._done(outs, t1, run)

    def decisions(self, run: Run) -> dict:
        return {g: ("screen", flat) for g, flat in run.captured.items()}

    def close(self) -> None:
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self._patched = []
        self.enc = None


ENTRIES = {"pipelined": Pipelined, "stream": Stream}
