"""The port's entry points (uvg266_tpu_torch.graft_entry) on the CPU.

entry() is the fused search step K12a -> K2 -> K3 -> K4 at 16x16 on a
128x128 plane: its best modes equal the JAX entry()'s exactly, its costs
to the float32 rounding of the reference's own sums (ROADMAP.md queue 3:
K4's bits are per-bucket counts x wts, within (n - 1) * 2^-24 relative of
the reference's sum over the n = 256 coefficients). dryrun_multichip runs
both mesh encoders with every byte-identity assertion."""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch import graft_entry

N_COEF = 16 * 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, so that parallel test workers (and the
    mesh's host threads) do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_equals_jax_entry():
    pytest.importorskip("jax")
    import __graft_entry__ as ref
    fn_j, args_j = ref.entry()
    best_j, cost_j = (np.asarray(a) for a in fn_j(*args_j))
    fn_t, args_t = graft_entry.entry(device="cpu")
    assert np.array_equal(args_t[0].numpy(), args_j[0])
    assert np.array_equal(args_t[1], args_j[1])
    assert np.array_equal(args_t[2], args_j[2])
    best_t, cost_t = fn_t(*args_t)
    assert best_t.dtype == torch.int32 and cost_t.dtype == torch.float32
    assert np.array_equal(best_t.numpy(), best_j)
    np.testing.assert_allclose(cost_t.numpy(), cost_j,
                               rtol=(N_COEF - 1) * 2.0 ** -24)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        assert graft_entry.entry()[1][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()


def test_dryrun_multichip_on_cpu():
    graft_entry.dryrun_multichip(8, device="cpu")


def test_dryrun_multichip_sharded_on_cpu():
    """One launch set a shard, each on its listed device (the 8 shards and
    the 4 closed-GOP runs on CPU devices)."""
    graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
