"""The port's kernel seam on the CPU (plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import rmsnorm as jrms
from repro_torch.kernels import ops

# f32: both sides accumulate in f32 and differ only in summation order.
# bf16: each side rounds its f32 result to bf16 once; an order difference
# can flip that rounding by one bf16 ulp (2**-8 relative), so 1e-2.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 7, 64])
@pytest.mark.parametrize("D", [64, 4096])
def test_rmsnorm_matches_pallas(D, R, dtype):
    rng = np.random.default_rng(D + R)
    xj, xt = _pair(rng.normal(size=(R, D)) * 3, dtype)
    g = rng.normal(size=(D,)).astype(np.float32)         # gamma stays f32
    want = jrms.rmsnorm(xj, jnp.asarray(g), eps=1e-5, interpret=True)
    got = ops.rmsnorm(xt, torch.from_numpy(g), 1e-5)
    assert got.dtype == TDT[dtype] and got.shape == (R, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(5, 64, 96), (33, 128, 130), (1, 48, 17)])
def test_matmul_matches_pallas(mkn, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(M * K + N)
    aj, at = _pair(rng.normal(size=(M, K)), dtype)
    bj, bt = _pair(rng.normal(size=(K, N)) / np.sqrt(K), dtype)
    want = jops.matmul(aj, bj, use_pallas=True)
    got = ops.matmul(at, bt)
    assert got.dtype == TDT[dtype] and got.shape == (M, N)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_flattens_leading_dims(dtype):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.normal(size=(2, 7, 64)), dtype)
    wj, wt = _pair(rng.normal(size=(64, 40)) / 8, dtype)
    want = jops.dense(xj, wj, use_pallas=True)
    got = ops.dense(xt, wt)
    assert got.shape == (2, 7, 40)
    _close(got, want, dtype)


def test_cpu_tensors_never_launch():
    ops.reset_launches()
    ops.dense(torch.ones(3, 8), torch.ones(8, 4))
    ops.rmsnorm(torch.ones(3, 8), torch.ones(8))
    assert ops.LAUNCHES == {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
                            "paged_attention": 0}


def test_wrappers_and_seam_share_one_launch_counter():
    """The wrappers count where they launch; ``ops`` shows the same dict."""
    from repro_torch.kernels import (flash_attention, launches, matmul,
                                     paged_attention, rmsnorm)
    assert ops.LAUNCHES is launches.LAUNCHES is matmul.LAUNCHES \
        is rmsnorm.LAUNCHES is flash_attention.LAUNCHES \
        is paged_attention.LAUNCHES
    launches.LAUNCHES["matmul"] = 5
    launches.LAUNCHES["paged_attention"] = 2
    ops.reset_launches()
    assert launches.LAUNCHES == {"rmsnorm": 0, "matmul": 0,
                                 "flash_attention": 0, "paged_attention": 0}


@pytest.mark.parametrize("kernel", ["matmul", "rmsnorm", "flash_attention",
                                    "paged_attention"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The kernel wrappers themselves never take a CPU tensor: there is no
    quiet switch to the plain version below ``ops``."""
    from repro_torch.kernels import (flash_attention, matmul, paged_attention,
                                     rmsnorm)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "matmul":
            matmul.matmul(torch.ones(2, 3), torch.ones(3, 4))
        elif kernel == "rmsnorm":
            rmsnorm.rmsnorm(torch.ones(2, 3), torch.ones(3), 1e-6)
        elif kernel == "flash_attention":
            q = torch.ones(1, 2, 3, 16)
            flash_attention.flash_attention(q, q, q)
        else:
            pool = torch.zeros(1, 3, 8, 16)
            paged_attention.paged_attention(
                torch.ones(1, 1, 2, 16), pool, pool,
                torch.zeros(1, 2, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))


def test_jax_on_cpu():
    assert jax.devices()[0].platform == "cpu"
