"""uvg266_tpu_torch: the PyTorch/CUDA port of uvg266-tpu for one NVIDIA H100.

Same ``Config``, ``Encoder.feed/flush`` and ``SliceEncoder`` API and the
same bitstreams as the JAX package ``uvg266_tpu``, which stays the
reference. The host code (numpy, the g++-built C++ in ``native/``) is a
copy of the reference's; the device search runs hand-written CUDA kernels
(``csrc/``, built by ``kernels``). Every encoder configuration is ported:
the all-intra frame search, its tool paths (MIP through the per-class
dispatch, intra MTS, the rough search), the low-delay / random-access P
and B slices (host ME with the device intra screen, or the all-device
dense search) and the per-class inter search that inter slices above 8
bits, with MTS or with MIP run (search_combined). The batched transforms
and quantisers (ops.transforms ``fwd_batch`` / ``inv_batch``, ops.quant
``quant_batch`` / ``dequant_batch``) have kernels too; as in the
reference, no encode path calls them.

The port runs on the card unless the caller passes ``device="cpu"``. On
the CPU every kernel wrapper computes its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

import functools
import inspect

import torch

# exact float32 everywhere: no TF32 in products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: the card unless the caller
    asks for the CPU. Raises when the card is asked for and absent. A card
    is always indexed (indexed_device): the per-device caches and launch
    sets key on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uvg266_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return indexed_device(dev)


def indexed_device(device) -> torch.device:
    """``device`` with its index: a bare 'cuda' is the calling thread's
    current card, 'cuda:i' must name a card of this machine."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev}: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def device_cache(fn):
    """``functools.lru_cache`` of ``fn``, whose argument ``device`` is a
    device string, keyed on the indexed device: a bare 'cuda' is the
    current card's 'cuda:i', so that a cache never hands one card's
    tensors to a launch on another."""
    cached = functools.lru_cache(maxsize=None)(fn)
    pos = list(inspect.signature(fn).parameters).index("device")

    @functools.wraps(fn)
    def call(*args, **kw):
        if "device" in kw:
            kw["device"] = _device_key(kw["device"])
        elif len(args) > pos:
            args = (*args[:pos], _device_key(args[pos]), *args[pos + 1:])
        return cached(*args, **kw)
    call.cache_clear = cached.cache_clear
    return call


def _device_key(device) -> str:
    return str(indexed_device(device)) if str(device) == "cuda" \
        else str(device)
