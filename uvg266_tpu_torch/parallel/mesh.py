"""The mesh encoders on one card: the reference's ('gop', 'tile') sharded
phase-1 search as batched launches.

The reference (uvg266_tpu/parallel/mesh.py) shards phase 1 (the batched CU
search) over a device mesh: the 'tile' axis partitions each frame's CU
batch by the tile the CU lives in, and the 'gop' axis puts several frames'
searches into one dispatch; per-frame RD stats are summed over 'tile'.
Here the mesh is a logical grid on one CUDA device, and a shard is a slice
of one batched launch, not a device:

- 'gop': frames batched along the block axis: control.encoder's
  _frames_search runs each class's search for the G frames as one launch
  of each kernel (K1 over all G planes, K2, K3 and K4 once for the class
  and batch), the same search the plain Encoder and the group dispatcher
  run.
- 'tile': the tile count of the config, which must equal the axis size.
  Each block's search does not depend on its tile, so on one card the axis
  changes no launch; the per-frame RD stat (the reference's psum over
  'tile') is the sum of every block's cost, taken on the host.

Phase 1b/2 (finalize, entropy) run per frame on the host through the
standard tile-substream path, so the output is byte-identical to the plain
Encoder with the same config (tests/test_torch_mesh.py).

MeshGopEncoder runs closed-GOP runs on host threads; every run's
source-only device request of a step (the P/B intra screen with its
on-device pseudo-recon, or an IDR's frame search) meets the others at a
barrier, and the last arriver launches the batch's kernels once for all
runs (_MeshGroupDispatch). Spreading the shards over several cards is not
done here.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import resolve_device


def tile_grid_for(n_tiles: int) -> tuple[int, int]:
    """Near-square (cols, rows) tile grid with cols*rows == n_tiles."""
    best = (n_tiles, 1)
    for rows in range(1, int(n_tiles ** 0.5) + 1):
        if n_tiles % rows == 0:
            best = (n_tiles // rows, rows)
    return best


class Mesh:
    """A logical device mesh on one card: ``shape`` maps each axis name to
    its size; every shard runs on ``device``."""

    def __init__(self, shape: dict, device):
        self.shape = dict(shape)
        self.device = device

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def build_mesh(n_devices: int, n_gop: int | None = None, device=None):
    """('gop', 'tile') mesh of n_devices shards on one card (default the
    CUDA device; raises without one unless device="cpu")."""
    if n_gop is None:
        n_gop = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    n_tile = n_devices // n_gop
    return Mesh({"gop": n_gop, "tile": n_tile}, resolve_device(device))


class MeshEncoder:
    """Encode frames with the phase-1 search batched over a ('gop', 'tile')
    mesh.

    cfg must use a tile grid whose tile count equals the mesh 'tile' axis
    size; the 'gop' axis batches that many frames per launch. All-intra
    only (inter DPB dependencies serialize frames; MeshGopEncoder carries
    closed GOPs instead).
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
        self._classes = None
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

    # --- frame batch search ----------------------------------------------

    def _search_batch(self, qp: int, srcs_y: list[np.ndarray]):
        """Batched phase-1 search for a batch of frames (len == n_gop) at
        one QP: control.encoder._frames_search over the G planes, one copy
        to the host, then the reference's per-frame reassembly.
        Returns (ctus_per_frame, frame_rd_stats)."""
        from ..control.encoder import _fetch_async, _frames_search
        from ..control.partition import PartitionSearch, qp_to_lambda
        from ..ops.tables import frame_tables

        G = self.n_gop
        assert len(srcs_y) == G
        _ps, classes = self._search_classes()
        searched = [cl for cl in classes if cl["positions"]]
        src = torch.from_numpy(np.stack(
            [s.astype(np.int32) for s in srcs_y])).to(self.device)
        tabs = frame_tables(qp, str(self.device))
        groups = [(G, self.ctrl.luma_qp_scaled(qp),
                   float(np.float32(qp_to_lambda(qp))), tabs["wts"])]
        flat = _fetch_async(_frames_search(
            tuple((cl["w"], cl["h"], cl["grid"], cl["xs"], cl["ys"])
                  for cl in searched), self.ctrl.bitdepth, src, groups,
            tabs["mode_bits"], rough=bool(getattr(self.cfg, "intra_rough",
                                                  False)),
            mip=bool(self.cfg.mip)))()          # one copy a batch

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

def build_gop_mesh(n_devices: int, device=None):
    """1-D ('gop',) mesh: each shard owns one closed-GOP frame run."""
    return Mesh({"gop": n_devices}, resolve_device(device))


class _MeshGroupDispatch:
    """Lockstep group dispatcher for per-GOP encoder workers: each
    worker's source-only device request (the P/B intra screen with its
    pseudo-recon, or an IDR's frame search) parks on a barrier; the last
    arriver stacks the G planes, runs the batch's kernels once (K1 -> K2 ->
    K3 over all G planes in one launch each, K5 and K4 once per group of
    slots that share qp_scaled, lambda and wts) and copies the result to
    the host once; every worker takes its row, the same vector its own
    call would give. Divergent request keys or a barrier timeout fall back
    to per-worker calls (the same kernels on the same card). An exception
    of the batched call is not caught: every slot re-raises it."""

    TIMEOUT_S = 600.0

    def __init__(self, mesh, n_slots: int):
        self.mesh = mesh
        self.device = mesh.device
        self.G = n_slots
        self.barrier = threading.Barrier(n_slots)
        self.slots: list = [None] * n_slots
        self.result = None
        self.error = None
        self.n_batched = 0          # batched calls (one per lockstep step)
        self.n_fallback = 0         # per-worker calls taken instead
        self._count = threading.Lock()

    def _batched(self, key, args: list) -> np.ndarray:
        """The batch's flat results [G, total] (numpy), row s for slot s.
        args[s]: (plane [H, W] int32, qp_scaled, lambda, qp)."""
        from ..control.encoder import (_fetch_async, _frames_search,
                                       _pseudo_by_group)
        from ..ops.tables import frame_tables

        kind, classes, bitdepth = key[0], key[1], key[-1]
        # slots that share (qp_scaled, lambda, qp) next to each other, so
        # that each group is one run of the batch's frames
        gkey = [(a[1], a[2], a[3]) for a in args]
        firsts = list(dict.fromkeys(gkey))
        order = sorted(range(self.G), key=lambda s: firsts.index(gkey[s]))
        dev = self.device
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
        flat = _fetch_async(_frames_search(classes, bitdepth, srcs, groups,
                                           mode_bits, refsrcs))()
        out = np.empty_like(flat)
        out[order] = flat
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
    device request of a step rides one batched launch per kernel
    (_MeshGroupDispatch). Output is byte-identical to encoding each run
    with a plain Encoder (tests/test_torch_mesh.py)."""

    def __init__(self, cfg, mesh):
        from ..control.encoder import Encoder

        self.cfg = cfg
        self.mesh = mesh
        self.G = mesh.shape["gop"]
        self.disp = _MeshGroupDispatch(mesh, self.G)
        self.encs = []
        for g in range(self.G):
            e = Encoder(cfg, device=mesh.device)
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
