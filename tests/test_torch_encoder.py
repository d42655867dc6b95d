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


# -- the HuggingFace checkpoint at model_path, and the checkpoint save side --


def _hf_state(tree, prefix=""):
    """The JAX parameter tree in HuggingFace BERT naming, Linear weights as
    torch stores them (``[out, in]``)."""
    e, lay = tree["embeddings"], tree["layers"]
    st = {
        "embeddings.word_embeddings.weight": e["word"],
        "embeddings.position_embeddings.weight": e["position"],
        "embeddings.token_type_embeddings.weight": e["token_type"],
        "embeddings.LayerNorm.weight": e["ln_scale"],
        "embeddings.LayerNorm.bias": e["ln_bias"],
    }
    names = {
        "attention.self.query": "q", "attention.self.key": "k", "attention.self.value": "v",
        "attention.output.dense": "o", "intermediate.dense": "wi", "output.dense": "wo",
    }
    for i in range(SMALL["num_layers"]):
        for hf, ours in names.items():
            st[f"encoder.layer.{i}.{hf}.weight"] = lay[f"{ours}_kernel"][i].T
            st[f"encoder.layer.{i}.{hf}.bias"] = lay[f"{ours}_bias"][i]
        for hf, ours in (("attention.output.LayerNorm", "attn_ln"), ("output.LayerNorm", "mlp_ln")):
            st[f"encoder.layer.{i}.{hf}.weight"] = lay[f"{ours}_scale"][i]
            st[f"encoder.layer.{i}.{hf}.bias"] = lay[f"{ours}_bias"][i]
    return {prefix + k: torch.from_numpy(np.array(v, order="C")) for k, v in st.items()}


def _write_hf(path, state, fmt):
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(state, str(path / "model.safetensors"))
    else:
        torch.save(state, path / "pytorch_model.bin")


def _embedders(path, vocab):
    from trie_semantic_search_tpu.core.config import EmbeddingModelConfig as JaxModelConfig
    from trie_semantic_search_tpu_torch.core.config import EmbeddingModelConfig

    jemb = JaxEmbedder(JaxModelConfig(model_path=str(path), max_sequence_length=64),
                       tokenizer=JaxTokenizer(vocab), model_config=jm.MiniLMConfig(**SMALL))
    temb = Embedder(EmbeddingModelConfig(model_path=str(path), max_sequence_length=64),
                    tokenizer=WordPieceTokenizer(vocab), model_config=tm.MiniLMConfig(**SMALL),
                    device="cpu")
    return jemb, temb


@pytest.mark.parametrize("fmt,prefix", [("bin", ""), ("bin", "bert."), ("safetensors", "0.auto_model.")])
def test_hf_checkpoint_at_model_path_matches_jax(models, tmp_path, fmt, prefix, monkeypatch):
    """A checkpoint in HuggingFace naming at ``model_path``: both loaders
    give the same parameters, bitwise, and both embedders (f32 compute)
    embed within 1e-5."""
    import functools

    jcfg, _, tree, _ = models
    _write_hf(tmp_path / "hf", _hf_state(tree, prefix), fmt)
    want = jm.load_hf_checkpoint(tmp_path / "hf", jcfg)
    got = tm.load_hf_checkpoint(tmp_path / "hf", tm.MiniLMConfig(**SMALL))
    for group in ("embeddings", "layers"):
        for name, arr in tree[group].items():
            np.testing.assert_array_equal(got[f"{group}.{name}"].numpy(), np.asarray(want[group][name]))
            np.testing.assert_array_equal(got[f"{group}.{name}"].numpy(), arr)
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    vocab = train_wordpiece_vocab(TEXTS, vocab_size=SMALL["vocab_size"], min_frequency=1)
    jemb, temb = _embedders(tmp_path / "hf", vocab)
    temb.model.compute_dtype = torch.float32
    np.testing.assert_allclose(temb.embed(TEXTS).embedding, jemb.embed(TEXTS).embedding, atol=1e-5, rtol=0)
    assert tm.load_hf_checkpoint(tmp_path / "empty_dir_or_none", tm.MiniLMConfig(**SMALL)) is None


def test_missing_or_corrupt_checkpoint_takes_the_seeded_init(models, tmp_path, caplog):
    """No path: the seeded init, silently. A checkpoint missing a tensor:
    a warning and the seeded init, in both packages; a tensor of the wrong
    shape: the same in the port."""
    _, _, tree, _ = models
    vocab = train_wordpiece_vocab(TEXTS, vocab_size=SMALL["vocab_size"], min_frequency=1)
    seeded = tm.MiniLM(tm.MiniLMConfig(**SMALL), device="cpu", seed=0).state_dict()
    jinit = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jm.MiniLMConfig(**SMALL)))

    def assert_seeded(jemb, temb):
        for k, v in temb.model.state_dict().items():
            torch.testing.assert_close(v, seeded[k], rtol=0, atol=0)
        if jemb is not None:
            for g in ("embeddings", "layers"):
                for n, arr in jinit[g].items():
                    np.testing.assert_array_equal(np.asarray(jemb.params[g][n]), arr)

    caplog.clear()
    assert_seeded(*_embedders(tmp_path / "nowhere", vocab))
    assert "HF checkpoint load failed" not in caplog.text
    state = _hf_state(tree)
    del state["encoder.layer.1.output.LayerNorm.bias"]
    _write_hf(tmp_path / "missing", state, "bin")
    caplog.clear()
    with caplog.at_level("WARNING"):
        assert_seeded(*_embedders(tmp_path / "missing", vocab))
    assert sum("HF checkpoint load failed" in r.message for r in caplog.records) == 2
    state = _hf_state(tree)
    state["embeddings.word_embeddings.weight"] = state["embeddings.word_embeddings.weight"][:7]
    _write_hf(tmp_path / "shape", state, "bin")
    caplog.clear()
    with caplog.at_level("WARNING"):
        from trie_semantic_search_tpu_torch.core.config import EmbeddingModelConfig

        temb = Embedder(EmbeddingModelConfig(model_path=str(tmp_path / "shape")),
                        tokenizer=WordPieceTokenizer(vocab), model_config=tm.MiniLMConfig(**SMALL),
                        device="cpu")
    assert_seeded(None, temb)
    assert "HF checkpoint load failed" in caplog.text


def test_save_checkpoint_restores_in_jax(models, tmp_path):
    """The port's ``save_checkpoint`` writes what the JAX package's
    ``restore_checkpoint`` reads (leaves in tree-flatten order), keeps the
    newest ``keep`` steps, and the restored parameters embed bitwise as the
    originals."""
    from trie_semantic_search_tpu.models.checkpoint import restore_checkpoint as jax_restore
    from trie_semantic_search_tpu_torch.models.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    jcfg, params, tree, model = models
    for step in (1, 5, 3, 7):
        save_checkpoint(tmp_path, step, model.state_dict(), metadata={"hidden_size": 64}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_5", "step_7"]
    assert latest_step(tmp_path) == 7
    jp, _, meta = jax_restore(tmp_path, jm.init_params(jax.random.PRNGKey(0), jcfg))
    assert meta == {"step": 7, "hidden_size": 64}
    for group in ("embeddings", "layers"):
        for name, arr in tree[group].items():
            np.testing.assert_array_equal(np.asarray(jp[group][name]), arr)
    ids, mask = _batch(seed=3)
    np.testing.assert_array_equal(
        np.asarray(jm.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)),
        np.asarray(jm.encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg)),
    )
    state, _ = restore_checkpoint(tmp_path, tm.MiniLMConfig(**SMALL))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
