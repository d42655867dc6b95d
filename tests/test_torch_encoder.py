"""The port's MiniLM against the JAX package's, with the JAX parameters
carried across by ``params_from_jax``.

Tolerances: in f32 compute the two differ only in summation order (max abs
1e-5 on unit-norm embeddings); in bf16 compute they also round at bf16 in
places whose inputs already differ by f32 noise, so the bound is a cosine
of at least 0.999 per embedding and max abs 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trie_semantic_search_tpu.models import minilm as jm
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import (
    WordPieceTokenizer as JaxTokenizer,
    train_wordpiece_vocab,
)
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer

torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=64)
TEXTS = [
    "Evidence obtained by searches in violation of the constitution.",
    "A police officer may stop and frisk a person upon reasonable suspicion.",
    "The state rule on evidence suppression follows independent grounds.",
    "miranda",
    "",
]


@pytest.fixture(scope="module")
def models():
    jcfg = jm.MiniLMConfig(**SMALL)
    params = jm.init_params(jax.random.PRNGKey(3), jcfg)
    # non-trivial biases and norms so every parameter is exercised
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: np.asarray(a), params)
    for name in list(tree["layers"]):
        if "bias" in name or "ln" in name:
            tree["layers"][name] = tree["layers"][name] + 0.05 * rng.standard_normal(
                tree["layers"][name].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    model = tm.MiniLM(tm.MiniLMConfig(**SMALL), device="cpu").load_params(
        tm.params_from_jax(tree)
    )
    return jcfg, params, tree, model


def _batch(seed=1, B=6, L=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, SMALL["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for b, n in enumerate([24, 20, 9, 3, 16, 2][:B]):
        mask[b, n:] = 0
        ids[b, n:] = 0
    return ids, mask


def test_params_from_jax_round_trip(models):
    _, _, tree, model = models
    state = model.state_dict()
    for group in ("embeddings", "layers"):
        for name, arr in tree[group].items():
            np.testing.assert_array_equal(state[f"{group}.{name}"].numpy(), arr)


def test_encode_matches_jax_f32(models):
    jcfg, params, _, model = models
    ids, mask = _batch()
    want = np.asarray(jm.encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                compute_dtype=jnp.float32))
    model.compute_dtype = torch.float32
    try:
        got = model.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    finally:
        model.compute_dtype = torch.bfloat16
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encode_matches_jax_bf16_with_sif_weights(models):
    jcfg, params, _, model = models
    ids, mask = _batch(seed=2)
    tw = np.random.default_rng(4).random(SMALL["vocab_size"]).astype(np.float32)
    want = np.asarray(jm.encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                token_weights=jnp.asarray(tw)))
    got = model.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                       torch.from_numpy(tw)).numpy()
    cos = (got * want).sum(axis=1)
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_embedder_bucketing_matches_jax(models):
    jcfg, params, tree, model = models
    vocab = train_wordpiece_vocab(TEXTS, vocab_size=SMALL["vocab_size"], min_frequency=1)
    jemb = JaxEmbedder(tokenizer=JaxTokenizer(vocab), params=params, model_config=jcfg)
    temb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    want = jemb.embed(TEXTS).embedding
    got = temb.embed(TEXTS).embedding
    assert got.shape == want.shape == (len(TEXTS), SMALL["hidden_size"])
    assert ((got * want).sum(axis=1)).min() >= 0.999
    assert temb.embed([]).embedding.shape == (0, SMALL["hidden_size"])


def test_seeded_init_is_deterministic():
    cfg = tm.MiniLMConfig(**SMALL)
    a = tm.MiniLM(cfg, device="cpu", seed=7).state_dict()
    b = tm.MiniLM(cfg, device="cpu", seed=7).state_dict()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    w = a["layers.q_kernel"]
    assert w.abs().max() <= 0.04 and 0.015 < float(w.std()) < 0.025
