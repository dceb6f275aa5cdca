"""Triton attention kernel tests.

On the CPU the kernel runs in the Pallas interpreter (`interpret=True`), at
every served sequence length and width, in bf16 and f32, with ragged
batches; its custom-VJP gradients are checked against `jax.grad` of the
plain reference, and its shard_map plumbing on the virtual device mesh.
The compiled kernel is checked on the card by chip_smoke.py (numerics c).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.ops.numerics import BF16, REFERENCE
from vitiq.ops.pallas import flash_attention as fa

# (L, D, H): the flagship ViT (129), rawIQ seg-16 (65) and seg-64 (17 / 16
# mean-pool) at d128/H8, rawiq_best (65 at d256/H8), vit_tiny (17 at
# d64/H4), conv1d (1025)
SHAPES = [(129, 128, 8), (65, 128, 8), (17, 128, 8), (16, 128, 8),
          (65, 256, 8), (17, 64, 4), (1025, 128, 8)]
SHAPE_IDS = [f"L{L}-D{D}-H{H}" for L, D, H in SHAPES]


def rand(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


def qkv(seed, B, L, D):
    rng = np.random.default_rng(seed)
    return tuple(rand(rng, B, L, D) for _ in range(3))


def reference(q, k, v, n_head):
    return fa.plain_packed_attention(q, k, v, n_head, REFERENCE)


# the production attention_fn, forced onto the kernel in the interpreter
INTERPRETED = functools.partial(fa.fused_attention, interpret=True)
INTERPRETED.packed_layout = True


class TestPallasKernelInterpret:
    @pytest.mark.parametrize("B", [1, 3, 5])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("L,D,H", SHAPES, ids=SHAPE_IDS)
    def test_matches_xla_reference(self, L, D, H, dtype, B):
        q, k, v = qkv(L + D + B, B, L, D)
        want = np.asarray(reference(q, k, v, H))
        cast = lambda t: t.astype(dtype)
        got = fa.kernel_attention(cast(q), cast(k), cast(v), H, interpret=True)
        assert got.shape == (B, L, D) and got.dtype == jnp.dtype(dtype)
        # f32: exact up to summation order; bf16 operands (f32 accumulation)
        # against the f32 reference: the bound chip_smoke applies on the card
        atol = 2e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol)

    def test_padded_query_rows_do_not_leak(self):
        """Rows past L in the last query block are masked on load and on
        store: a batch row's output does not depend on its neighbours."""
        q, k, v = qkv(3, 2, 17, 64)
        both = fa.kernel_attention(q, k, v, 4, interpret=True)
        solo = fa.kernel_attention(q[:1], k[:1], v[:1], 4, interpret=True)
        np.testing.assert_allclose(np.asarray(both[:1]), np.asarray(solo),
                                   atol=1e-6)

    def test_large_logits_stay_finite(self):
        """The running max keeps exp2 in range where a max-free softmax
        would overflow (scores ~ 1e3)."""
        q, k, v = qkv(4, 2, 65, 128)
        got = fa.kernel_attention(30 * q, 30 * k, v, 8, interpret=True)
        assert np.isfinite(np.asarray(got)).all()
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(reference(30 * q, 30 * k, v, 8)),
                                   atol=1e-3)  # f32 rounding of ~1e3 exponents


class TestKernelGradients:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("L,D,H", SHAPES, ids=SHAPE_IDS)
    def test_custom_vjp_matches_reference_grad(self, L, D, H, dtype):
        q, k, v = qkv(L + D, 2 if L <= 129 else 1, L, D)
        w = rand(np.random.default_rng(1), *q.shape)
        attn = INTERPRETED
        policy = REFERENCE if dtype == "float32" else BF16

        def loss_kernel(q, k, v):
            out = attn(q, k, v, H, policy=policy).astype(jnp.float32)
            return jnp.sum(out * w)

        def loss_ref(q, k, v):
            return jnp.sum(reference(q, k, v, H) * w)

        got = jax.grad(loss_kernel, argnums=(0, 1, 2))(q, k, v)
        want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for g, r in zip(got, want):
            assert g.dtype == jnp.float32  # cast back through the policy
            scale = float(jnp.max(jnp.abs(r)))
            err = float(jnp.max(jnp.abs(g - r))) / scale
            assert err < (1e-5 if dtype == "float32" else 3e-2), err


class TestBatchTiledBackward:
    """The backward recompute is batch-tiled when the score tensors would
    exceed an eighth of the device's memory limit. Chunked and un-chunked
    backwards must agree exactly, also when the chunk does not divide the
    batch."""

    def _grads(self, monkeypatch, budget):
        monkeypatch.setattr(fa, "bwd_budget_bytes", lambda: budget)
        q, k, v = qkv(7, 5, 16, 32)

        def loss(q, k, v):
            return jnp.sum(fa._attention(q, k, v, 4, True) ** 2)

        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    @pytest.mark.parametrize("budget", [20000, 30000, 4 * 16 * 16 * 7 * 5])
    def test_chunked_matches_unchunked(self, monkeypatch, budget):
        full = self._grads(monkeypatch, None)  # no limit reported: one chunk
        tiled = self._grads(monkeypatch, budget)
        for a, b in zip(full, tiled):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_budget_from_device_limit(self, monkeypatch):
        class Dev:
            def memory_stats(self):
                return {"bytes_limit": 8 * 1000}

        monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
        assert fa.bwd_budget_bytes() == 1000

    def test_no_limit_on_host(self):
        # the CPU reports no memory limit: the backward does not chunk
        assert fa.bwd_budget_bytes() is None


class TestRoute:
    @pytest.mark.parametrize("interpret", [False, True])
    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("scores", [False, True])
    def test_route(self, backend, masked, scores, interpret):
        mask = jnp.ones((1, 1, 4, 4)) if masked else None
        want = ("kernel" if (backend == "gpu" or interpret)
                and not masked and not scores else "plain")
        assert fa.attention_route(mask, scores, backend=backend,
                                  interpret=interpret) == want

    def test_gpu_choice_runs_nothing(self, monkeypatch):
        """The GPU route is chosen from the backend name alone: tracing
        fused_attention under a GPU backend name reaches the kernel wrapper
        without running (or compiling) any kernel."""
        calls = []
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(fa, "sharded_kernel_attention",
                            lambda *a, **k: calls.append(a) or a[0])
        q, k, v = qkv(0, 2, 17, 64)
        fa.fused_attention(q, k, v, 4, policy=BF16)
        assert len(calls) == 1 and calls[0][0].dtype == jnp.bfloat16

    def test_cpu_takes_plain_path(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("kernel reached on the CPU")

        monkeypatch.setattr(fa, "sharded_kernel_attention", boom)
        q, k, v = qkv(1, 2, 17, 64)
        got = fa.fused_attention(q, k, v, 4)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(reference(q, k, v, 4)), atol=1e-6)

    def test_mask_and_scores_take_plain_path(self):
        q, k, v = qkv(2, 2, 9, 32)
        mask = jnp.tril(jnp.ones((9, 9)))[None, None]
        out, scores = fa.fused_attention(q, k, v, 4, mask=mask,
                                         return_scores=True)
        assert scores.shape == (2, 4, 9, 9)
        np.testing.assert_allclose(np.asarray(scores[0, 0, 0, 1:]), 0.0,
                                   atol=1e-6)

    @pytest.mark.parametrize("kw", [{"mask": jnp.ones((1, 1, 9, 9))},
                                    {"return_scores": True}])
    def test_interpret_with_mask_or_scores_takes_plain_path(self, monkeypatch,
                                                             kw):
        def boom(*a, **k):
            raise AssertionError("kernel reached with a mask or scores")

        monkeypatch.setattr(fa, "sharded_kernel_attention", boom)
        q, k, v = qkv(3, 1, 9, 32)
        got = INTERPRETED(q, k, v, 4, **kw)
        want = fa.plain_packed_attention(q, k, v, 4, REFERENCE, **kw)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    @pytest.mark.parametrize("L,block", [(1, 16), (16, 16), (17, 32), (64, 64),
                                         (65, 64), (129, 64), (1025, 64)])
    def test_block_size(self, L, block):
        assert fa.block_size(L) == block


class TestKernelOnMesh:
    """Under a mesh the kernel runs per shard inside shard_map: the batch
    over 'data' and, under tensor parallelism, the packed heads over
    'model'. Forward and gradients match the unsharded reference."""

    @pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
    def test_forward_and_grad(self, data, model):
        from vitiq.parallel.mesh import make_mesh

        q, k, v = qkv(11, 8, 17, 64)
        attn = INTERPRETED
        mesh = make_mesh(data=data, model=model)
        with mesh:
            got = jax.jit(lambda a, b, c: attn(a, b, c, 4))(q, k, v)
            g = jax.jit(jax.grad(lambda a: jnp.sum(attn(a, k, v, 4) ** 2)))(q)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(reference(q, k, v, 4)), atol=1e-5)
        g_ref = jax.grad(lambda a: jnp.sum(reference(a, k, v, 4) ** 2))(q)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-4)


class TestModelWithKernel:
    @pytest.mark.parametrize("arm", ["vit", "rawiq"])
    def test_forward_matches_plain_attention(self, arm):
        """The whole model with the kernel (interpret) as attention_fn
        reproduces the plain-attention model in f32."""
        from vitiq.config import ModelConfig
        from vitiq.models import init_amc_params, make_forward

        if arm == "vit":
            cfg = ModelConfig(arm="vit", num_classes=3, d_model=32, n_head=4,
                              n_layers=2, ffn_hidden=64, drop_prob=0.0,
                              img_size_h=16, img_size_w=16, seq_length=128)
            x = rand(np.random.default_rng(5), 3, 1, 16, 16)
        else:
            cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                              n_layers=2, ffn_hidden=64, drop_prob=0.0,
                              seq_length=64, segment_size=16)
            x = rand(np.random.default_rng(5), 3, 2, 64)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        plain = make_forward(cfg)
        kernel = make_forward(cfg, attention_fn=INTERPRETED)
        np.testing.assert_allclose(np.asarray(plain(params, x)),
                                   np.asarray(kernel(params, x)), atol=2e-5)


@pytest.mark.gpu
def test_compiled_kernel_on_card(gpu):
    """The kernel as compiled for the card (no interpreter) against the f32
    reference at every served shape."""
    import chip_smoke

    for r in chip_smoke.attention_errors(batch=8):
        assert r["max_abs_err"] <= chip_smoke.ATTENTION_ABS, r
