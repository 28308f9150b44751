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

import torch

# exact float32 everywhere: no TF32 in products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: the card unless the caller
    asks for the CPU. Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uvg266_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
