"""The row-blocked prefill on the CPU (``models.transformer.
shared_prefill``, which a card runs for a serving engine whose prefix
cache shares pages, so that a prompt's rows get the same bits under every
prefill bucket): its layer stack against the unblocked one and against
JAX's prefill, its padding, its attention, the host path left as it was,
and which engines take it.

On the host ``blocks.row_mm`` and ``shared_prefill`` do not block (a host
GEMM's rows do not depend on the row count), so the blocked stack runs
here through ``_dense_prefill_layers(rows=...)`` directly: its
projections are whole (``row_mm`` blocks on a card only), its attention
``attention.prefix_chunk_attention`` in query chunks of ``rows``, and the
prompt zero-padded to a multiple of ``rows``.

Tolerances, each with its reason: a chunk's softmax runs over its key
prefix in one pass where the flash scan sums key blocks online, so the
blocked stack and the chunked attention agree with the unblocked ones
within float32 rounding (atol 1e-5, rtol 1e-5); against JAX, the logits
tolerance of ``tests/test_torch_lm.py`` (atol 1e-4, rtol 1e-3), and JAX's
K/V, which its cache holds in bfloat16, within one bfloat16 rounding
(2^-8); the host's ``shared_prefill`` against ``prefill``, bitwise.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_prefill_rows.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, blocks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.weights import tree_to_numpy  # noqa: E402

ARCH = "qwen2-0.5b"
TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=128, compute_dtype="float32")
MAX_LEN = 64
F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def model():
    cfg = dataclasses.replace(get_config(ARCH), **TINY)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params


def blocked_prefill(cfg, params, tokens, lens, rows):
    """``prefill``'s dense path with the row blocks forced on (``rows``;
    ``None``: off), into a float32 cache: (logits at each row's last
    position, cache)."""
    cdt = torch.float32
    b = tokens.shape[0]
    cache = T.init_cache(cfg, b, MAX_LEN, dtype=cdt, device="cpu")
    h = T.embed_tokens(params, tokens, cfg, cdt)
    h = T._dense_prefill_layers(params, h, cfg, cdt, cache, "flash", "float",
                                256, rows)
    h = blocks.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    idx = (lens - 1)[:, None, None].expand(b, 1, h.shape[-1])
    return T.unembed(params, torch.gather(h, 1, idx), cfg), cache


def prompts(n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab"], (2, n), generator=gen)


@pytest.mark.parametrize("bucket,rows", [(16, 16), (32, 16), (16, 32),
                                         (48, 32)])
def test_blocked_stack_matches_unblocked(bucket, rows):
    """Logits at each row's last real position and the cache's K/V (the
    pad rows' not written) against the unblocked prefill, at buckets a
    multiple of ``rows`` and not (48 rows in blocks of 32: padded to 64;
    16 in blocks of 32: padded to 32)."""
    cfg, params = model()
    toks = prompts(bucket)
    lens = torch.tensor([bucket, bucket - 5], dtype=torch.int32)
    want, wc = blocked_prefill(cfg, params, toks, lens.long(), None)
    got, gc = blocked_prefill(cfg, params, toks, lens.long(), rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(gc[key].numpy(), wc[key].numpy(), **F32)
        assert not gc[key][:, :, bucket:].any()


def test_blocked_rows_do_not_depend_on_the_bucket():
    """A prompt's rows prefilled at buckets 32 and 64 in blocks of 16:
    the same K/V rows and logits (the host's GEMMs already give rows that
    do not depend on the row count; the blocks keep the attention's
    schedule of a row the same at every bucket)."""
    cfg, params = model()
    toks = prompts(64)
    toks[:, 20:] = 0
    lens = torch.tensor([20, 20])
    a, ca = blocked_prefill(cfg, params, toks[:, :32], lens, 16)
    b, cb = blocked_prefill(cfg, params, toks, lens, 16)
    assert torch.equal(a, b)
    for key in ("k", "v"):
        assert torch.equal(ca[key][:, :, :20], cb[key][:, :, :20])


def test_blocked_stack_matches_jax_prefill():
    """The blocked stack's logits and K/V against JAX's prefill of the
    same weights (``weights.tree_to_numpy``)."""
    cfg, params = model()
    jcfg = dataclasses.replace(j_get_config(ARCH), **TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(params))
    toks = prompts(32, seed=3)
    lens = torch.tensor([32, 27], dtype=torch.int32)
    want, wc = JT.prefill(jparams, jnp.asarray(toks.numpy()), jcfg, MAX_LEN,
                          prompt_lens=jnp.asarray(lens.numpy()))
    got, gc = blocked_prefill(cfg, params, toks, lens.long(), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            gc[key].to(torch.bfloat16).float().numpy(),
            np.asarray(wc[key], np.float32), atol=2 ** -8, rtol=2 ** -8)


def test_host_shared_prefill_is_prefill():
    """On the host ``shared_prefill_fn`` is ``prefill_fn``, bitwise:
    ``row_mm`` is ``x @ w`` and the prefill stays unblocked, with the
    caller's ``attn_impl``."""
    cfg, params = model()
    gen = torch.Generator().manual_seed(5)
    x, w = torch.randn(5, 3, 32, generator=gen), torch.randn(32, 7,
                                                            generator=gen)
    assert torch.equal(blocks.row_mm(x, w, 2), x @ w)
    toks = prompts(32)
    batch = {"tokens": toks, "prompt_lens": torch.tensor([32, 9])}
    for impl in ("flash", "full"):
        a, ca = api.prefill_fn(cfg, MAX_LEN, attn_impl=impl)(params, batch)
        b, cb = api.shared_prefill_fn(cfg, MAX_LEN, attn_impl=impl)(params,
                                                                    batch)
        assert torch.equal(a, b)
        assert all(torch.equal(ca[k], cb[k]) for k in ca)


@pytest.mark.parametrize("sq,rows", [(32, 16), (48, 16), (64, 32)])
def test_prefix_chunk_attention(sq, rows):
    """``prefix_chunk_attention`` against causal ``full_attention`` (GQA,
    4 query heads on 2 KV heads), and a row's output the same bits inside
    a longer sequence (the chunk's shapes are set by its index alone)."""
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(sq)
    q, k, v = (torch.randn(2, 2 * sq, h, 8, generator=gen)
               for h in (4, 2, 2))
    got = A.prefix_chunk_attention(q[:, :sq], k[:, :sq], v[:, :sq], rows)
    want = A.full_attention(q[:, :sq], k[:, :sq], v[:, :sq], causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    longer = A.prefix_chunk_attention(q, k, v, rows)
    assert torch.equal(longer[:, :sq], got)


@pytest.mark.parametrize("layout,prefix_cache,shared", [
    ("paged", True, True), ("paged", False, False),
    ("contiguous", True, False)])
def test_engine_takes_shared_prefill_where_pages_are_shared(
        monkeypatch, layout, prefix_cache, shared):
    """The engine prefills through ``shared_prefill_fn`` only where its
    prefix cache can share a page (the paged layout with the cache on),
    and through ``prefill_fn`` with its ``attn_impl`` everywhere else."""
    from repro_torch.serve import Engine, ServeConfig
    made = []
    for name in ("prefill_fn", "shared_prefill_fn"):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _n=name, _f=real, **kw: (
            made.append((_n, kw["attn_impl"])), _f(*a, **kw))[1])
    cfg, params = model()
    Engine(cfg, params, ServeConfig(max_len=MAX_LEN, kv_layout=layout,
                                    prefix_cache=prefix_cache,
                                    attn_impl="flash_tri"), jit=False)
    want = "shared_prefill_fn" if shared else "prefill_fn"
    assert made == [(want, "flash_tri")]
