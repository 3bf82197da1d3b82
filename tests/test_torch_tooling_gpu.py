"""The tooling's checks that need the card (marked ``gpu``; they skip
where there is none): the autotuner measures every plan of the small
cases, each held to its plain version; a tuned table's plans run and stay
within the kernels' tolerance of the untuned ones (split-K changes the
order of the f32 sums, so not to the bit), the same bits twice; the
serve_batch twin's streams on the card equal the CPU's.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tooling_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import autotune as at
from repro_torch.kernels import matmul, ops, ref
from repro_torch.testing import kernel_checks as kc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", at.KERNELS)
def test_autotune_measures_every_plan_on_the_card(cuda, tmp_path, kernel):
    with at.tuned(tmp_path / "cache.json", top_k=3, reps=3) as ctx:
        for shape, dtype in at.SMOKE_CASES[kernel]:
            rec = at.autotune(kernel, shape, dtype, ctx=ctx, measure_all=True)
            measured = [e for e in rec["candidates"] if "measured_us" in e]
            assert len(measured) == len(rec["candidates"])
            assert all(e["measured_us"] > 0 and e["limit_use"] <= 1 for e in measured)
            assert rec["topology"] == torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 4096, 1024), (128, 4096, 4096), (333, 4096, 1024)])
def test_a_tuned_plan_stays_within_tolerance_of_the_untuned(cuda, M, K, N):
    a, b = kc.matmul_inputs(M, K, N, torch.bfloat16)
    base = matmul.matmul(a, b)
    kind = matmul.variant(M, K, N, torch.bfloat16)
    for n in matmul.legal_splits(kind, M, K, N):
        ctx = at.TuneContext(topology_tag=torch.cuda.get_device_name(0))
        ctx.table[at.signature("matmul", (M, K, N), "bfloat16", ctx.topology_tag)] = \
            {"winner": {"splits": n}}
        with at.tuned(ctx):
            got, again = ops.matmul(a, b), ops.matmul(a, b)
        assert torch.equal(got, again)
        assert kc.compare(got, base, kc.MATMUL_TOL[torch.bfloat16])["ok"]
        assert kc.compare(got, ref.matmul(a, b), kc.MATMUL_TOL[torch.bfloat16])["ok"]


@pytest.mark.gpu
def test_serve_batch_streams_on_the_card_equal_the_cpus(cuda):
    from repro_torch.examples import serve_batch
    gpu = {r.rid: list(r.out) for r in serve_batch.main(["--device", "cuda"])}
    cpu = {r.rid: list(r.out) for r in serve_batch.main(["--device", "cpu"])}
    assert gpu == cpu
