"""The port stands alone: uvg266_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the kernel wrappers never fall back.

The import check runs in a subprocess, since tests/conftest.py imports jax:
there ``sys.modules["jax"]`` and ``sys.modules["uvg266_tpu"]`` are None, so
any import of either (by exact name, or of a submodule) fails.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import uvg266_tpu_torch
from uvg266_tpu_torch import kernels
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import me
from uvg266_tpu_torch.ops import me_frame as mf
from uvg266_tpu_torch.ops import mip
from uvg266_tpu_torch.ops import pseudo_recon as pr
from uvg266_tpu_torch.ops import quant as qu
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb
from uvg266_tpu_torch.ops import transforms as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(uvg266_tpu_torch.__file__))

_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["uvg266_tpu"] = None
import numpy as np
import uvg266_tpu_torch
for m in pkgutil.walk_packages(uvg266_tpu_torch.__path__, "uvg266_tpu_torch."):
    if not m.name.rsplit(".", 1)[-1].startswith("_"):    # built libraries
        importlib.import_module(m.name)
from uvg266_tpu_torch.cfg import Config
from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
from uvg266_tpu_torch.oracle.decoder import decode_au
cfg = Config(width=64, height=64, qp=27, gop_len=0, intra_period=1,
             sao_type=3, alf_type=0, deblock_enable=True, rdoq_enable=False,
             signhide_enable=True, dep_quant=False, wpp=False)
rng = np.random.default_rng(0)
y = rng.integers(0, 256, (64, 64)).astype(np.int32)
u = rng.integers(0, 256, (32, 32)).astype(np.int32)
enc = Encoder(cfg, device="cpu")
out = enc.feed(FramePlanes(y, u, u.copy())) + enc.flush()
au, rec, fs = out[0][0], out[0][1], out[0][2]
dec, info = decode_au(au, cfg, enc.ctrl, fs)
assert info["checksum_ok"] is True and (dec.y == rec.y).all()
assert not any(k == "jax" or k.startswith(("jax.", "uvg266_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED", len(au))
"""


def test_port_runs_without_jax_or_the_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_the_reference(path):
    """Also catches imports inside functions, which the subprocess above
    only reaches on the paths it runs."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "uvg266_tpu"), (path, n)


# relative imports of modules the port does not have yet, each reached only
# under a configuration the port refuses: none since ops/mip.py was ported
_GATED_MISSING: set = set()


def _relative_imports(path):
    """(line, absolute module) of every relative import in ``path``,
    inside functions too; ``from . import x`` yields the package and x."""
    rel = os.path.relpath(path, os.path.dirname(PKG))
    pkg = os.path.dirname(rel).replace(os.sep, ".")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = pkg.split(".")
            base = base[:len(base) - (node.level - 1)]
            mod = ".".join(base + ([node.module] if node.module else []))
            if node.module:
                yield node.lineno, mod
            else:
                for a in node.names:
                    yield node.lineno, f"{mod}.{a.name}"


def _resolves(mod):
    """``mod`` is a module file of the port, or a name that its package's
    __init__.py defines at top level (``from .. import resolve_device``)."""
    rel = os.path.join(os.path.dirname(PKG), *mod.split("."))
    if os.path.isfile(rel + ".py") or os.path.isfile(
            os.path.join(rel, "__init__.py")):
        return True
    init = os.path.join(os.path.dirname(rel), "__init__.py")
    if not os.path.isfile(init):
        return False
    with open(init) as fh:
        tree = ast.parse(fh.read())
    name = mod.rsplit(".", 1)[-1]
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            found = [node.name]
        elif isinstance(node, ast.Assign):
            found = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            found = [a.asname or a.name for a in node.names]
        else:
            continue
        if name in found:
            return True
    return False


@pytest.mark.parametrize("path", sorted(p for p in _sources()
                                        if p.startswith(PKG)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_relative_imports_resolve(path):
    """Every relative import, inside functions too, names a module of the
    port: an import only a rare path reaches fails there and nowhere else
    (the port once lacked ops/me.py, which the default rdoq finalize
    imports, and ops/mip.py). The list of gated exceptions is empty."""
    missing = [(line, mod) for line, mod in _relative_imports(path)
               if not _resolves(mod) and mod not in _GATED_MISSING]
    assert not missing, missing


def test_gated_missing_modules_are_still_missing_and_gated():
    """The exception list holds only modules that are really absent (none
    now: ops.mip resolves), and no configuration is refused any more: MIP
    in inter slices (the per-class search_combined) is accepted as
    all-intra MIP is."""
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import Encoder
    assert not _GATED_MISSING
    for mod in _GATED_MISSING:
        assert not _resolves(mod), f"{mod} exists: drop it from the list"
    assert _resolves("uvg266_tpu_torch.ops.mip")
    assert _resolves("uvg266_tpu_torch.ops.me")
    for kw in (dict(gop_len=4), dict(gop_len=0, intra_period=1)):
        Encoder(Config(width=64, height=64, mip=True, **kw), device="cpu")


def test_wrappers_raise_instead_of_falling_back():
    """A tensor on a device with no kernel, and a CUDA launch where no card
    (or no nvcc) is present, raise; nothing falls back to the plain path."""
    meta = dict(device="meta", dtype=torch.int32)
    tabs = tb.tables_to_torch(tb.class_tables(8, 8, 8), "meta")
    ft = tb.tables_to_torch({"wts": tb.FAST_COEFF_WTS[22].astype("float32"),
                             "mode_bits": tb.MODE_BITS}, "meta")
    calls = [
        lambda: ib.refs_blocks_grid(torch.empty((16, 16), **meta), 8, 8,
                                    (0, 0, 8, 8, 2, 2)),
        lambda: ib.predict67(torch.empty((4, 780), **meta), tabs),
        lambda: ib.satd67(torch.empty((4, 67, 8, 8), **meta),
                          torch.empty((4, 8, 8), **meta)),
        lambda: rd.rd_cost(torch.empty((4, 67, 8, 8), **meta),
                           torch.empty((4, 8, 8), **meta),
                           torch.empty((4, 67), **meta), 22, 57.9,
                           ft["wts"], ft["mode_bits"], tabs, 8),
        lambda: ib.refs_blocks_grid(torch.empty((16, 16), **meta), 8, 8,
                                    (0, 0, 8, 8, 2, 2),
                                    torch.empty((16, 16), **meta)),
        lambda: pr.pseudo_recon(torch.empty((32, 48), **meta), 27),
        lambda: rd.rd_cost_pred(torch.empty((4, 8, 8), **meta),
                                torch.empty((4, 8, 8), **meta), 22, 57.9,
                                ft["wts"], torch.empty((4,), device="meta"),
                                tabs, 8),
        lambda: mf.frame_inter(torch.empty((16, 16), **meta),
                               torch.empty((48, 48), **meta),
                               torch.empty((1089,), device="meta"),
                               torch.empty((1089,), device="meta"),
                               ((8, 8, (0, 0, 8, 8, 2, 2)),)),
        lambda: mf.leaf_qpel(torch.empty((4, 18, 18), **meta),
                             torch.empty((4, 8, 8), **meta),
                             torch.empty((4,), **meta), 2,
                             torch.empty((49,), device="meta")),
        lambda: ib.refs_blocks(torch.empty((16, 16), **meta), [0, 8], [0, 8],
                               8, 8),
        lambda: mip.mip_preds(torch.empty((16, 16), **meta), [0, 8], [0, 8],
                              8, 8, 8, torch.empty((8, 16, 8), device="meta",
                                                   dtype=torch.uint8)),
        lambda: rd.mts_search(torch.empty((4, 8, 8), **meta),
                              torch.empty((4, 8, 8), **meta), 22, 57.9,
                              ft["wts"],
                              tb.tables_to_torch(tb.mts_class_tables(8, 8),
                                                 "meta"), 8),
        # K3 and K4 at a MIP candidate count
        lambda: ib.satd67(torch.empty((4, 16, 8, 8), **meta),
                          torch.empty((4, 8, 8), **meta)),
        lambda: rd.rd_cost(torch.empty((4, 16, 8, 8), **meta),
                           torch.empty((4, 8, 8), **meta),
                           torch.empty((4, 16), **meta), 22, 57.9,
                           ft["wts"], torch.empty((16,), device="meta"),
                           tabs, 8),
        # the per-class inter search and the rough search
        lambda: me.fullpel_search(torch.empty((16, 16), **meta),
                                  torch.empty((2, 8, 8), **meta),
                                  torch.empty((2,), **meta),
                                  torch.empty((2,), **meta), 16,
                                  torch.empty((1089,), device="meta"), 8),
        lambda: me.frac_search(*(torch.empty(s_, **meta) for s_ in
                                 ((16, 16), (2, 8, 8), (2,), (2,), (2,),
                                  (2,))),
                               torch.empty((49,), device="meta"), 8),
        lambda: ib.predict67(torch.empty((4, 780), **meta), tabs,
                             torch.empty((35,), **meta)),
        lambda: ib.predict_modes(torch.empty((4, 780), **meta),
                                 torch.empty((4, 4), **meta), tabs),
        lambda: rd.rough_select(torch.empty((4, 35), **meta), 57.9,
                                ft["mode_bits"], torch.empty((35,), **meta)),
        lambda: rd.rough_pick(torch.empty((4, 35), **meta),
                              torch.empty((4, 4), **meta),
                              torch.empty((4, 4), **meta), 57.9,
                              ft["mode_bits"], torch.empty((35,), **meta),
                              torch.empty((4, 35, 8, 8), **meta),
                              torch.empty((4, 4, 8, 8), **meta)),
        lambda: rd.rough_refine(torch.empty((4, 780), **meta),
                                torch.empty((4, 8, 8), **meta), 22, 57.9,
                                ft["wts"], ft["mode_bits"], tabs, 8,
                                torch.empty((35,), **meta)),
        # the batched transforms and quantisers
        lambda: tr.fwd_batch(torch.empty((4, 8, 16), **meta), 2, 1, 10),
        lambda: tr.inv_batch(torch.empty((4, 8, 16), **meta), 2, 1, 10),
        lambda: qu.quant_batch(torch.empty((4, 8, 16), **meta), 22, 8),
        lambda: qu.dequant_batch(torch.empty((4, 8, 16), **meta), 22, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no kernel for device"):
            call()
    if not torch.cuda.is_available():
        for name in kernels.SIGNATURES:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                kernels.launch(name, torch.device("cuda"))
        assert all(v == 0 for v in kernels.LAUNCHES.values())
