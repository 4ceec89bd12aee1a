"""The port's synthetic token stream against the reference's, on the CPU.

`repro_torch.data.tokens` carries its own threefry-2x32, `PRNGKey`,
`fold_in`, JAX's partitionable `random_bits`, the float32 uniform, the
Gumbel draw and `categorical`.  Integers must equal JAX's exactly: keys,
raw bits, and every token and label of `batch_at` at several (seed,
step, shape), a vocabulary of 151,936 (the Qwen archs') included.  The
Gumbel values are float32 logs on both sides; the tokens they pick are
held equal too (no argmax flipped at these draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.tokens import TokenPipeline as RPipe  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as RCfg  # noqa: E402
from repro_torch.data import tokens as TK  # noqa: E402


@pytest.mark.parametrize("seed,data", [(0, 0), (7, 3), (12345, 2 ** 31),
                                       (2 ** 32 - 1, 99)])
def test_keys_and_fold_in_equal_jax(seed, data):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in jax.random.key_data(key)) == \
        TK.prng_key(seed)
    folded = jax.random.key_data(jax.random.fold_in(key, data))
    assert tuple(int(x) for x in folded) == TK.fold_in(TK.prng_key(seed),
                                                       data)


@pytest.mark.parametrize("shape", [(5, 7), (1,), (3, 4, 9), (1000,)])
def test_random_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = np.asarray(jax.random.bits(key, shape)).ravel().astype(np.int64)
    n = int(np.prod(shape))
    got = TK.random_bits(TK.fold_in(TK.prng_key(7), 3), 0, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # any slice of the flat layout is the same bits (row-block draws)
    part = TK.random_bits(TK.fold_in(TK.prng_key(7), 3), n // 3, n - n // 3,
                          "cpu")
    np.testing.assert_array_equal(part.numpy(), want[n // 3:])


def test_uniform_and_gumbel_equal_jax():
    key = jax.random.PRNGKey(5)
    tiny = float(np.finfo(np.float32).tiny)
    want_u = np.asarray(jax.random.uniform(key, (4096,), jnp.float32,
                                           minval=tiny, maxval=1.0))
    want_g = np.asarray(jax.random.gumbel(key, (4096,), jnp.float32))
    bits = TK.random_bits(TK.prng_key(5), 0, 4096, "cpu")
    np.testing.assert_array_equal(TK.uniform_from_bits(bits, tiny).numpy(),
                                  want_u)
    np.testing.assert_allclose(TK.gumbel_from_bits(bits).numpy(), want_g,
                               rtol=2e-6, atol=2e-6)


def test_categorical_equals_jax():
    logits = np.log(np.random.default_rng(0).dirichlet(np.ones(300)))
    logits = logits.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 4)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                             shape=(6, 11)))
    got = TK.categorical(TK.fold_in(TK.prng_key(1), 4),
                         torch.from_numpy(logits), (6, 11),
                         max_elements=1000)        # several row blocks
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,step,vocab,B,S", [
    (0, 0, 128, 4, 32), (1, 5, 8192, 2, 17), (3, 11, 151936, 2, 9),
    (12345, 2, 65536, 3, 33), (0, 1000, 64, 8, 16)])
def test_batches_equal_reference(seed, step, vocab, B, S):
    cfg = dict(vocab=vocab, seq_len=S, global_batch=B, seed=seed)
    want = RPipe(RCfg(**cfg)).batch_at(step)
    got = TK.TokenPipeline(TK.TokenPipelineConfig(**cfg),
                           device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (B, S)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_stateless_resume_and_shifted_labels():
    pipe = TK.TokenPipeline(TK.TokenPipelineConfig(vocab=512, seq_len=24,
                                                   global_batch=3, seed=9),
                            device="cpu")
    a, b = pipe.batch_at(7), TK.TokenPipeline(pipe.cfg, "cpu").batch_at(7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], pipe.batch_at(8)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # the bigram positions repeat a function of their predecessor
    full = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)
    idx = 15
    assert torch.equal(full[:, idx], (full[:, idx - 1] * 31 + 7) % 512)


def test_host_batch_slices_global():
    cfg = dict(vocab=256, seq_len=8, global_batch=8, seed=2)
    pipe = TK.TokenPipeline(TK.TokenPipelineConfig(**cfg), device="cpu")
    full = pipe.batch_at(4)
    ref = RPipe(RCfg(**cfg))
    for host in range(4):
        part = pipe.host_batch_at(4, host, 4)
        want = ref.host_batch_at(4, host, 4)
        for k in full:
            assert torch.equal(part[k], full[k][2 * host:2 * host + 2])
            np.testing.assert_array_equal(part[k].numpy(),
                                          np.asarray(want[k]))


def test_pipeline_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.TokenPipeline(TK.TokenPipelineConfig(vocab=8, seq_len=4,
                                                global_batch=1))
