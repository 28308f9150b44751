"""The mesh encoders: the reference's ('gop', 'tile') sharded phase-1
search, on one card or on several.

The reference (uvg266_tpu/parallel/mesh.py) shards phase 1 (the batched CU
search) over a device mesh: the 'tile' axis partitions each frame's CU
batch by the tile the CU lives in, the 'gop' axis puts several frames'
searches into one dispatch, and the per-frame RD stats are psum'd over
'tile'. A ``Mesh`` here holds a device for each shard, in the mesh's shape
(``Mesh.devices``, the counterpart of ``jax.sharding.Mesh.devices``), and
runs in one of two layouts:

- batched (``build_mesh(n, device=d)``): every shard on the card ``d`` in
  one launch set. control.encoder's _frames_search runs each class's
  search for the G frames as one launch of each kernel (K1 over all G
  planes, K2, K3 and K4 once for the class and batch), the same search the
  plain Encoder and the group dispatcher run; the 'tile' axis changes no
  launch.
- sharded (``devices=[...]``, or no device: the first n cards, as the
  reference takes ``jax.devices()[:n]``): one launch set a shard, each on
  its own device and on a stream of its own. Shard (g, t) runs
  _frames_search on frame g's plane and tile t's blocks (K1 on the tile's
  rectangle of each class lattice, K12a where a tile's positions form no
  grid); every shard is enqueued before the first result is fetched, so
  the cards work at the same time. A list may repeat a card: its shards
  then each get their own stream there (how one card, or the CPU, reaches
  this code).

In both layouts the per-frame RD stat (the reference's psum over 'tile')
is the float64 host sum of every block's cost, whose inputs the host reads
back anyway to rebuild the partition. So one process drives every card,
as the reference drives its devices from one process, and no collective
is needed.

Phase 1b/2 (finalize, entropy) run per frame on the host through the
standard tile-substream path, so the output is byte-identical to the plain
Encoder with the same config (tests/test_torch_mesh.py,
tests/test_torch_mesh_sharded.py).

MeshGopEncoder runs closed-GOP runs on host threads; every run's
source-only device request of a step (the P/B intra screen with its
on-device pseudo-recon, or an IDR's frame search) meets the others at a
barrier, and the last arriver enqueues the step's launch sets
(_MeshGroupDispatch): one for all runs on a batched mesh, one a run
otherwise, each on that run's card. Run g's Encoder is built on the
mesh's device g, so each run's own device work (K8 with rdoq, K7/K6 with
the dense search, K9a/K9b/K6 above 8 bits) stays on its own card, on that
card's default stream. The reference's runs' Encoders sit on the default
device instead; the difference is one of placement only, and no plane
crosses cards.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import resolve_device
from ..consts import LCU_WIDTH


def tile_grid_for(n_tiles: int) -> tuple[int, int]:
    """Near-square (cols, rows) tile grid with cols*rows == n_tiles."""
    best = (n_tiles, 1)
    for rows in range(1, int(n_tiles ** 0.5) + 1):
        if n_tiles % rows == 0:
            best = (n_tiles // rows, rows)
    return best


class Mesh:
    """A device mesh: ``shape`` maps each axis name to its size, and
    ``devices``, an array of that shape, holds each shard's device.
    ``batched``: every shard on one card in one launch set (the layout of
    ``device=``), else one launch set a shard."""

    def __init__(self, shape: dict, devices, batched: bool = False):
        self.shape = dict(shape)
        flat = list(devices)
        if len(flat) != int(np.prod(list(self.shape.values()))):
            raise ValueError(f"{len(flat)} devices for a mesh {self.shape}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(tuple(self.shape.values()))
        self.batched = batched
        if batched and len(set(flat)) != 1:
            raise ValueError("a batched mesh lies on one device")

    @property
    def device(self) -> torch.device:
        """The first shard's device, which holds the host-side Encoder."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return f"Mesh({self.shape}, devices={devs}, batched={self.batched})"


def mesh_devices(n: int, device=None, devices=None):
    """The n shards' devices and whether they form one launch set, by the
    rule of build_mesh: ``device`` (every shard on it, batched),
    ``devices`` (a list of n, one launch set a shard; repeats allowed),
    or neither (the first n cards; raises, naming both counts, when the
    machine has fewer)."""
    if device is not None and devices is not None:
        raise ValueError("pass device= or devices=, not both")
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} shards")
        return devs, False
    if device is not None:
        return [resolve_device(device)] * n, True
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"a mesh of {n} shards takes the first {n} CUDA devices and this "
            f"machine has {have}; pass device= to batch every shard on one "
            "card, or devices= to place each shard")
    return [torch.device("cuda", i) for i in range(n)], False


def build_mesh(n_devices: int, n_gop: int | None = None, device=None,
               devices=None):
    """('gop', 'tile') mesh of n_devices shards (the reference's shape
    rule), its devices by mesh_devices: the first n_devices cards by
    default, every shard on ``device`` in one launch set, or the listed
    ``devices`` one launch set a shard."""
    if n_gop is None:
        n_gop = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    n_tile = n_devices // n_gop
    devs, batched = mesh_devices(n_devices, device, devices)
    return Mesh({"gop": n_gop, "tile": n_tile}, devs[:n_gop * n_tile],
                batched)


@contextlib.contextmanager
def on_card(dev: torch.device, stream=None):
    """``dev`` the current card, and ``stream`` (if any) its current
    stream, for the block; nothing on the CPU."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _stream(dev: torch.device):
    """A stream of its own on ``dev`` (None on the CPU)."""
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


class MeshEncoder:
    """Encode frames with the phase-1 search over a ('gop', 'tile') mesh.

    cfg must use a tile grid whose tile count equals the mesh 'tile' axis
    size; the 'gop' axis batches that many frames a search. All-intra
    only (inter DPB dependencies serialize frames; MeshGopEncoder carries
    closed GOPs instead). On a batched mesh every shard rides one launch
    set; otherwise shard (g, t) searches frame g's tile t on the mesh's
    device (g, t), on a stream of its own.
    """

    def __init__(self, cfg, mesh):
        from ..control.encoder import Encoder

        self.mesh = mesh
        self.n_gop = mesh.shape["gop"]
        self.n_tile = mesh.shape["tile"]
        n_tiles = cfg.tiles_width_count * cfg.tiles_height_count
        if n_tiles != self.n_tile:
            raise ValueError(
                f"cfg tile grid ({n_tiles} tiles) must match the mesh "
                f"'tile' axis ({self.n_tile})")
        if cfg.gop_len != 0 or cfg.intra_period > 1:
            raise ValueError("MeshEncoder is all-intra (gop 0)")
        self.cfg = cfg
        self.enc = Encoder(cfg, device=mesh.device)
        self.ctrl = self.enc.ctrl
        self.device = self.enc.slice_enc.device
        # shard (g, t): its device and stream (sharded meshes only)
        self._shards = None if mesh.batched else [
            [(d, _stream(d)) for d in row] for row in mesh.devices]
        self._classes = None
        self._plan = None
        self.frame_rd_stats: list[float] = []   # per-frame RD of every block

    # --- geometry ---------------------------------------------------------

    def _search_classes(self):
        """Shape classes of the partition search with their positions (the
        order dispatch_blocks gives them) and the static grid K1 takes where
        the positions form one (shared by every frame: same geometry)."""
        if self._classes is not None:
            return self._classes
        from ..control.partition import PartitionSearch
        from ..ops.intra_batch import grid_of_positions

        ps = PartitionSearch(self.ctrl, self.cfg, qp=self.cfg.qp)
        rough = bool(getattr(self.cfg, "intra_rough", False))
        # a class with no position (64x64 below 64 samples) is not
        # searched; its costs stay INF
        classes = [{
            "key": key, "w": w, "h": h, "positions": positions,
            "shape": shape,
            "xs": np.array([p[0] for p in positions], dtype=np.int32),
            "ys": np.array([p[1] for p in positions], dtype=np.int32),
            "grid": None if rough or not positions
            else grid_of_positions(positions, w, h)}
            for key, w, h, positions, shape in ps._classes()]
        self._classes = (ps, classes)
        return self._classes

    def _tile_plan(self):
        """Per tile t: (the classes its shards search, as _frames_search
        takes them: (w, h, grid, xs, ys) of the tile's positions of each
        class that has any, in class order; the index in a batch row of
        each value of such a shard's result). The tile of a block is the
        tile of its CTU (the reference's _tile_of); a tile's positions of
        a class lattice are a raster rectangle, a grid for K1, and take
        K12a where they form none."""
        if self._plan is not None:
            return self._plan
        from ..ops.intra_batch import grid_of_positions

        _ps, classes = self._search_classes()
        rough = bool(getattr(self.cfg, "intra_rough", False))
        n_out = 4 if self.cfg.mip else 2    # best, rd (MIP best, cost)
        plan = [([], []) for _ in range(self.n_tile)]
        off = 0
        for cl in classes:
            w, h, pos = cl["w"], cl["h"], cl["positions"]
            tile = np.array([self.ctrl.tile_index_of_ctu(
                x // LCU_WIDTH, y // LCU_WIDTH) for x, y in pos], dtype=int)
            for t, (cls_t, dst_t) in enumerate(plan):
                idx = np.flatnonzero(tile == t)
                if not len(idx):
                    continue
                grid = None if rough else grid_of_positions(
                    [pos[k] for k in idx], w, h)
                cls_t.append((w, h, grid, cl["xs"][idx], cl["ys"][idx]))
                dst_t.append((off + np.arange(n_out)[:, None] * len(pos)
                              + idx[None, :]).reshape(-1))
            off += n_out * len(pos)
        self._plan = ([(tuple(c), np.concatenate(d) if d else None)
                       for c, d in plan], off)
        return self._plan

    # --- frame batch search ----------------------------------------------

    def _search_flat(self, qp: int, srcs_y: list[np.ndarray]) -> np.ndarray:
        """The batch's search results [G, total] (numpy float32), row g
        frame g's [best_0 | rd_0 (| MIP best_0 | cost_0) | best_1 | ...]
        over the classes in order, each in its positions' order."""
        from ..control.encoder import _fetch_async, _frames_search
        from ..control.partition import qp_to_lambda
        from ..ops.tables import frame_tables

        G = self.n_gop
        rough = bool(getattr(self.cfg, "intra_rough", False))
        mip = bool(self.cfg.mip)
        qps = self.ctrl.luma_qp_scaled(qp)
        lam = float(np.float32(qp_to_lambda(qp)))

        def search(classes, src, n):
            tabs = frame_tables(qp, str(src.device))
            return _fetch_async(_frames_search(
                classes, self.ctrl.bitdepth, src, [(n, qps, lam, tabs["wts"])],
                tabs["mode_bits"], rough=rough, mip=mip))

        if self._shards is None:
            # one launch set: the G planes in one search, one copy a batch
            _ps, classes = self._search_classes()
            src = torch.from_numpy(np.stack(
                [s.astype(np.int32) for s in srcs_y])).to(self.device)
            return search(tuple((cl["w"], cl["h"], cl["grid"], cl["xs"],
                                 cl["ys"]) for cl in classes
                                if cl["positions"]), src, G)()
        plan, total = self._tile_plan()
        planes = {}         # (card, frame) -> the plane, copied once a batch
        pend = []
        for g in range(G):
            for t, (classes, dst) in enumerate(plan):
                if dst is None:
                    continue
                dev, stream = self._shards[g][t]
                with on_card(dev, stream):
                    src = planes.get((dev, g))
                    if src is None:
                        src = planes[dev, g] = torch.from_numpy(
                            srcs_y[g].astype(np.int32)[None]).to(dev)
                    if stream is not None:
                        src.record_stream(stream)
                    pend.append((g, dst, search(classes, src, 1)))
        # every shard is enqueued: now wait for each one's copy
        flat = np.empty((G, total), dtype=np.float32)
        for g, dst, fetch in pend:
            flat[g, dst] = fetch()[0]
        return flat

    def _search_batch(self, qp: int, srcs_y: list[np.ndarray]):
        """Phase-1 search for a batch of frames (len == n_gop) at one QP,
        then the reference's per-frame reassembly.
        Returns (ctus_per_frame, frame_rd_stats)."""
        from ..control.partition import PartitionSearch

        G = self.n_gop
        assert len(srcs_y) == G
        _ps, classes = self._search_classes()
        flat = self._search_flat(qp, srcs_y)

        if self.cfg.mip:
            from ..ops.mip import mip_mode_count

        # reassemble per frame in original position order; the per-frame
        # RD stat (the reference's psum over 'tile') sums every class's rd
        cost_f = [dict() for _ in range(G)]
        mode_f = [dict() for _ in range(G)]
        frame_rd = np.zeros(G, dtype=np.float64)
        off = 0
        for cl in classes:
            npos = len(cl["positions"])
            best_a = flat[:, off:off + npos]
            rd_a = flat[:, off + npos:off + 2 * npos]
            off += 2 * npos
            if self.cfg.mip:
                mbest_a = flat[:, off:off + npos]
                mcost_a = flat[:, off + npos:off + 2 * npos]
                off += 2 * npos
                n_modes = mip_mode_count(cl["w"], cl["h"])
            frame_rd += rd_a.sum(-1, dtype=np.float64)
            for g in range(G):
                descs = [None] * npos
                costs = np.empty(npos, dtype=np.float64)
                for k in range(npos):
                    c = float(rd_a[g, k])
                    d = {"type": "intra", "mode": int(best_a[g, k]),
                         "tr_idx": 0}
                    if self.cfg.mip and mcost_a[g, k] < c:
                        c = float(mcost_a[g, k])
                        mi = int(mbest_a[g, k])
                        d = {"type": "intra", "mode": mi % n_modes,
                             "mip": True, "mip_t": mi >= n_modes,
                             "tr_idx": 0}
                    descs[k] = d
                    costs[k] = c
                PartitionSearch._store(cost_f[g], mode_f[g], cl["key"],
                                       cl["w"], cl["h"], cl["positions"],
                                       cl["shape"], descs, costs)

        ctus = [PartitionSearch(self.ctrl, self.cfg, qp=qp)._decide(
            cost_f[g], mode_f[g]) for g in range(G)]
        return ctus, frame_rd

    # --- public API -------------------------------------------------------

    def encode(self, frames: list) -> list[tuple[bytes, object]]:
        """Encode frames (FramePlanes, display order). Batches of n_gop
        frames share one batched search; finalize/entropy run per frame on
        the host through the standard tile-substream path.
        Returns [(au_bytes, recon), ...]."""
        from ..control.encoder import pad_plane

        out = []
        w, h = self.ctrl.in_width, self.ctrl.in_height
        i = 0
        while i < len(frames):
            batch = frames[i:i + self.n_gop]
            # ragged tail: encode leftover frames with a full batch by
            # repeating the last frame; surplus results are dropped
            pad_n = self.n_gop - len(batch)
            searched = batch + [batch[-1]] * pad_n
            srcs_y = [pad_plane(f.y, w, h) for f in searched]
            ctus_b, frame_rd = self._search_batch(self.cfg.qp, srcs_y)
            for f, ctus, frd in zip(batch, ctus_b, frame_rd):
                au, rec, fs, _refs = self.enc.encode_frame(
                    self.enc.feed_count, f,
                    prefetch=lambda c=ctus: c)
                self.enc.feed_count += 1
                self.frame_rd_stats.append(float(frd))
                out.append((au, rec))
            i += self.n_gop
        return out


# --- closed-GOP inter batching ----------------------------------------------

def build_gop_mesh(n_devices: int, device=None, devices=None):
    """1-D ('gop',) mesh: each shard owns one closed-GOP frame run; its
    devices as build_mesh's."""
    devs, batched = mesh_devices(n_devices, device, devices)
    return Mesh({"gop": n_devices}, devs, batched)


class _MeshGroupDispatch:
    """Lockstep group dispatcher for per-GOP encoder workers: each
    worker's source-only device request (the P/B intra screen with its
    pseudo-recon, or an IDR's frame search) parks on a barrier; the last
    arriver enqueues the step's launch sets, then copies each one's result
    to the host; every worker takes its row, the same vector its own call
    would give. A batched mesh has one launch set for every slot: the G
    planes stacked, K1 -> K2 -> K3 over all of them in one launch each, K5
    and K4 once per group of slots that share qp_scaled, lambda and wts.
    Otherwise each slot is a launch set of its own, on its run's card and a
    stream of its own. Divergent request keys or a barrier timeout fall
    back to per-worker calls (the same kernels on the same cards), counted
    in n_fallback. An exception of the batched call is not caught: every
    slot re-raises it."""

    TIMEOUT_S = 600.0

    def __init__(self, mesh, n_slots: int):
        self.mesh = mesh
        self.G = n_slots
        if mesh.batched:
            self.sets = [(mesh.device, None, tuple(range(n_slots)))]
        else:
            devs = list(mesh.devices.flat)
            if len(devs) != n_slots:
                raise ValueError(f"{n_slots} slots on a mesh of {len(devs)}")
            self.sets = [(d, _stream(d), (s,)) for s, d in enumerate(devs)]
        self.barrier = threading.Barrier(n_slots)
        self.slots: list = [None] * n_slots
        self.result = None
        self.error = None
        self.n_batched = 0          # batched calls (one per lockstep step)
        self.n_fallback = 0         # per-worker calls taken instead
        self._count = threading.Lock()

    def _enqueue(self, key, args: list, dev):
        """One launch set's search on ``dev``, enqueued: (order, fetch),
        fetch() -> the flat results [n, total] (numpy) whose row i belongs
        to args[order[i]]. args[s]: (plane [H, W] int32, qp_scaled,
        lambda, qp)."""
        from ..control.encoder import (_fetch_async, _frames_search,
                                       _pseudo_by_group)
        from ..ops.tables import frame_tables

        kind, classes, bitdepth = key[0], key[1], key[-1]
        # slots that share (qp_scaled, lambda, qp) next to each other, so
        # that each group is one run of the batch's frames
        gkey = [(a[1], a[2], a[3]) for a in args]
        firsts = list(dict.fromkeys(gkey))
        order = sorted(range(len(args)), key=lambda s: firsts.index(gkey[s]))
        srcs = torch.from_numpy(np.stack(
            [np.asarray(args[s][0], dtype=np.int32) for s in order])
        ).to(dev)
        groups = [(gkey.count(k), k[0], k[1],
                   frame_tables(k[2], str(dev))["wts"]) for k in firsts]
        mode_bits = frame_tables(firsts[0][2], str(dev))["mode_bits"]
        if kind == "pframe_intra":
            if tuple(srcs.shape[1:]) != (key[2], key[3]):
                raise ValueError("group dispatch: planes of another size")
            refsrcs = _pseudo_by_group(srcs, groups, bitdepth)
        else:
            refsrcs = None
        return order, _fetch_async(_frames_search(classes, bitdepth, srcs,
                                                  groups, mode_bits, refsrcs))

    def _batched(self, key, args: list) -> np.ndarray:
        """The step's flat results [G, total] (numpy), row s for slot s:
        every launch set enqueued on its card, then each one fetched."""
        pend = []
        for dev, stream, slots in self.sets:
            with on_card(dev, stream):
                pend.append((slots, *self._enqueue(
                    key, [args[s] for s in slots], dev)))
        out = None
        for slots, order, fetch in pend:
            flat = fetch()
            if out is None:
                out = np.empty((self.G, flat.shape[1]), dtype=flat.dtype)
            out[[slots[i] for i in order]] = flat
        return out

    def _fallback(self, fallback):
        with self._count:
            self.n_fallback += 1
        return fallback()

    def run(self, slot: int, key, args, fallback):
        """args: (plane [H, W] int32 numpy, qp_scaled, lambda, qp).
        Returns this slot's flat result vector (numpy)."""
        self.slots[slot] = (key, args)
        try:
            idx = self.barrier.wait(timeout=self.TIMEOUT_S)
        except threading.BrokenBarrierError:
            return self._fallback(fallback)
        if idx == 0:
            self.result = self.error = None
            if len({k for (k, _a) in self.slots}) == 1:
                try:
                    self.result = self._batched(
                        key, [a for (_k, a) in self.slots])
                    self.n_batched += 1
                except BaseException as e:     # re-raised by every slot
                    self.error = e
        try:
            self.barrier.wait(timeout=self.TIMEOUT_S)
        except threading.BrokenBarrierError:
            return self._fallback(fallback)
        if self.error is not None:
            raise self.error
        r = self.result
        if r is None:
            return self._fallback(fallback)
        return r[slot]


class MeshGopEncoder:
    """Closed-GOP data-parallel encoder over a 1-D ('gop',) mesh: the input
    sequence splits into IDR-led runs, one a shard; each run is driven by a
    full Encoder (LD or RA reordering, per-frame GOP QP offsets) on its own
    host thread, so ME, finalize, filters and entropy overlap across host
    cores (the C++ phases release the GIL), while every run's source-only
    device request of a step meets the others' in one step of
    _MeshGroupDispatch (one batched launch per kernel on a batched mesh,
    one launch set a run otherwise). Run g's Encoder lies on the mesh's
    device g. Output is byte-identical to encoding each run with a plain
    Encoder (tests/test_torch_mesh.py, tests/test_torch_mesh_sharded.py)."""

    def __init__(self, cfg, mesh):
        from ..control.encoder import Encoder

        self.cfg = cfg
        self.mesh = mesh
        self.G = mesh.shape["gop"]
        self.disp = _MeshGroupDispatch(mesh, self.G)
        self.encs = []
        for g in range(self.G):
            e = Encoder(cfg, device=mesh.devices.flat[g])
            e.slice_enc._mesh_dispatch = self.disp
            e.slice_enc._mesh_slot = g
            self.encs.append(e)

    def encode(self, frames: list) -> list[list]:
        """frames: display order, length divisible by the mesh size.
        Returns per-GOP result lists ([(au, rec, fs, refs, src), ...])
        in sequence order; concatenating the per-GOP AUs yields the
        multi-IDR stream."""
        from concurrent.futures import ThreadPoolExecutor

        n = len(frames)
        if n % self.G:
            raise ValueError(f"{n} frames not divisible into {self.G} "
                             f"equal closed-GOP runs")
        L = n // self.G
        chunks = [frames[g * L:(g + 1) * L] for g in range(self.G)]

        def work(g):
            try:
                # the run's card current on its thread (a new thread starts
                # on card 0)
                with on_card(self.encs[g].slice_enc.device):
                    outs = []
                    for f in chunks[g]:
                        outs.extend(self.encs[g].feed(f))
                    outs.extend(self.encs[g].flush())
                    return outs
            except BaseException:
                # release the other runs from the barrier at once
                self.disp.barrier.abort()
                raise

        with ThreadPoolExecutor(self.G) as ex:
            return list(ex.map(work, range(self.G)))
