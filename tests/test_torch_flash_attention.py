"""Port parity: flash attention's plain version against the JAX package's.

``repro_torch.kernels.flash_attention.mha_ref`` (the CPU path of the port's
flash attention) against ``repro.kernels.flash_attention.flash_attention_ref``
(the JAX oracle) and against the Pallas kernel in interpret mode
(``flash_attention(..., interpret=True)``, as ``tests/test_kernels.py``
runs it), on the same numpy inputs: the shapes of ``tests/test_kernels.py``
(GQA causal, MHA bidirectional, MQA sliding window, a ``q_offset``
continuation, window == block) plus head dims 16 and 80, a length that is
no multiple of 32, and 8 query heads per kv head; hubert-xlarge's D 80
without the causal mask at G 2 over 131 keys (no multiple of any key
tile), and D 16 causal from ``q_offset`` 5 with a window of 9.

Tolerances: float32 within ``atol = rtol = 5e-5`` of both (the same
products summed in other orders; the Pallas kernel's online softmax
rescales in steps). bfloat16 within ``atol = rtol = 3e-2`` (the tolerance of
``tests/test_kernels.py``): the port rounds the normalized probabilities to
bf16 before ``P.V`` as the JAX oracle does, the Pallas kernel its
unnormalized ``p`` per block, and both round the output.

Every query row here sees at least one key: for a row that sees none the
kernels give 0 and the oracles the mean of ``v``, a case the model's path
never produces (causal attention at ``q_offset >= 0`` always sees key 0 or
the row's own position).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref
from repro_torch.bridge import to_tensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import bench
from repro_torch.kernels.flash_attention.ref import visible_mask
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

# the oracle jitted: one compile per shape instead of one per op
j_ref = jax.jit(flash_attention_ref, static_argnames=("causal", "window", "q_offset", "scale"))
F32_TOL = dict(atol=5e-5, rtol=5e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

CASES = [
    # b, hq, hkv, s, t, d, causal, window, q_offset
    (2, 4, 2, 128, 128, 64, True, None, 0),     # GQA causal
    (1, 8, 8, 64, 64, 32, False, None, 0),      # MHA bidirectional (encoder)
    (2, 4, 1, 128, 128, 64, True, 48, 0),       # MQA sliding window
    (1, 2, 2, 16, 128, 64, True, None, 112),    # decode continuation
    (1, 4, 4, 256, 256, 128, True, 128, 0),     # window == block
    (1, 4, 2, 45, 45, 16, True, 8, 0),          # gemma smoke heads, S % 32 != 0
    (1, 2, 2, 40, 53, 80, False, 11, 3),        # stablelm's head dim
    (1, 16, 2, 96, 96, 32, True, None, 0),      # G = 8
    (1, 4, 2, 131, 131, 80, False, None, 0),    # hubert's D 80, no causal mask, G 2
    (1, 4, 2, 40, 45, 16, True, 9, 5),          # D 16, causal from q_offset 5, window 9
]


def _inputs(case, dtype):
    b, hq, hkv, s, t, d = case[:6]
    rng = np.random.default_rng(hq * 1000 + s + d)
    arrs = [(rng.standard_normal(shape) * 0.3).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jarrs = [jnp.asarray(a).astype(jd) for a in arrs]
    return jarrs, [to_tensor(np.asarray(a)) for a in jarrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_plain_version_matches_jax_oracle_and_pallas_kernel(case, dtype):
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    assert visible_mask(case[3], case[4], **kw).any(-1).all(), "a row sees no key"
    got = fa.flash_attention(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == q.dtype
    got = got.float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want_ref = np.asarray(j_ref(jq, jk, jv, **kw), np.float32)
    np.testing.assert_allclose(got, want_ref, **tol)
    want_kernel = np.asarray(j_flash(jq, jk, jv, **kw, block_q=32, block_k=32,
                                     interpret=True), np.float32)
    np.testing.assert_allclose(got, want_kernel, **tol)


def test_strided_views_and_scale():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views; an
    explicit ``scale`` replaces D ** -0.5."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 24, 6, 16), dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 24, 3, 16), dtype=np.float32))
    q, k = x.permute(0, 2, 1, 3), kv.permute(0, 2, 1, 3)
    got = fa.flash_attention(q, k, k, window=5, scale=0.3)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), k.contiguous(), window=5,
                              scale=0.3)
    assert torch.equal(got, want)
    jwant = j_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(k.numpy()),
                  window=5, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32_TOL)


def test_kernel_kinds_on_the_cpu():
    q = torch.zeros((1, 2, 4, 16))
    assert torch.equal(fa.flash_attention(q, q, q, kernel="ref"),
                       fa.flash_attention(q, q, q, kernel="auto"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention(q, q, q, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="kernel must be"):
        fa.flash_attention(q, q, q, kernel="pallas")


def test_tile_counts_takes_cuda_tensors_only():
    """The counting launch has no plain version: on CPU tensors it raises
    before building the kernel, and counts no launch."""
    from repro_torch.kernels.flash_attention import kernel

    q = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16)
    before = fa.LAUNCHES.count
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.tile_counts(q, q, q, causal=True)
    assert fa.LAUNCHES.count == before and kernel._lib is None


@pytest.mark.parametrize("name", sorted(bench.SHAPES))
def test_bench_work_counts(name):
    """The bound's work counts: visible pairs against the mask itself (at a
    tenth of the length), one exponential a pair, the gemma global layer's
    67.1 M pairs and hubert's 2 x 16 x 4,096^2."""
    B, Hq, Hkv, S, T, D, causal, window, q_offset, Dv = bench.SHAPES[name]
    s, t = S // 10, T // 10
    w = None if window is None else window // 10
    assert bench.visible_pairs(s, t, causal=causal, window=w, q_offset=q_offset) == int(
        visible_mask(s, t, causal=causal, window=w, q_offset=q_offset).sum())
    work = bench.needed_work(bench.SHAPES[name])
    assert work["flops"] == 2 * (D + Dv) * work["pairs"]
    assert work["exps"] == work["pairs"]
    assert work["bytes"] == 2 * (B * Hq * S * (D + Dv) + B * Hkv * T * (D + Dv))
    if name == "gemma3-4b global":
        assert work["pairs"] == 8 * 4096 * 4097 // 2
        assert work["flops"] == 4 * 256 * work["pairs"]
    if name == "hubert-xlarge":
        assert work["pairs"] == 2 * 16 * 4096 * 4096
    if name == "deepseek-v2-lite mla":
        assert (D, Dv, work["pairs"]) == (192, 128, 16 * 4096 * 4097 // 2)
        assert work["flops"] == 640 * work["pairs"]
