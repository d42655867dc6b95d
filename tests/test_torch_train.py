"""The port's encoder training against the JAX package's, on the same numpy
inputs and the same parameters (carried across by ``params_from_jax``).

Tolerances:

* Pairs, views, batches and negative masks: bitwise (host numpy on the same
  ``default_rng`` seeds in both packages).
* One step at f32 compute: the loss within 1e-5, the accuracy equal, each
  gradient leaf within ``GRAD_RTOL`` of that leaf's largest magnitude plus
  1e-9 (the two differ in summation order only; the key bias's gradient is
  zero in exact arithmetic and f32 noise of 1e-11 in both).
* The schedule's factor: optax computes it in f32, so within 1e-6 of its
  value plus 1e-6 of the peak (a few f32 ulps of the peak, which the
  warmup's ``(0 - peak) * (1 - c / w) + peak`` rounds at).
* AdamW: ``PARAM_TOL`` per element after five steps. Adam divides by
  sqrt(v): where a gradient is f32 noise (the key bias above), the two
  packages' noise differs and its update can differ by up to the learning
  rate times about 1e-3 per step, while everywhere else the parameters
  agree to about 1e-7.
* ``pretrain_encoder`` in bf16 compute: each logged loss within
  ``BF16_LOSS_TOL`` (bf16 rounding at places whose inputs differ by f32
  noise, compounded over 12 steps).
"""

import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import trie_semantic_search_tpu.models.minilm as jm
import trie_semantic_search_tpu.models.train as jt
from trie_semantic_search_tpu.core.config import EmbeddingModelConfig as JaxEmbeddingModelConfig
from trie_semantic_search_tpu.models.checkpoint import restore_checkpoint as jax_restore
from trie_semantic_search_tpu.models.checkpoint import save_checkpoint as jax_save
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.quality import pair_ranking_accuracy as jax_pair_ranking_accuracy
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu_torch.core.config import EmbeddingModelConfig
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models import train as tt
from trie_semantic_search_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.quality import pair_ranking_accuracy
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=32)
GRAD_RTOL = 2e-5
PARAM_TOL = 5e-6
BF16_LOSS_TOL = 2e-2

TOPICS = ["due process", "habeas corpus", "eminent domain", "double jeopardy"]


def _docs(n: int = 24, seed: int = 0) -> list[list[str]]:
    """Legal-style documents with digits and synonym-lexicon words."""
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n):
        t = TOPICS[d % len(TOPICS)]
        docs.append([
            f"case number {d} presents a question of {t} under review "
            f"and the record at trial {int(rng.integers(0, 999))} controls",
            f"the court held that the {t} claim turns on the evidence "
            f"developed below in docket {int(rng.integers(0, 999))}",
            f"the judgment on the {t} question is affirmed and remanded "
            f"for proceedings consistent with this opinion part {d}",
        ] + (["the appeal was dismissed by the tribunal."] if d % 3 == 0 else []))
    return docs


def _tokenizers(docs, vocab_size=512):
    vocab = train_wordpiece_vocab(iter([" ".join(s) for s in docs]), vocab_size=vocab_size)
    return JaxTokenizer(vocab), WordPieceTokenizer(vocab), len(vocab)


def _params(seed: int = 0, **over):
    cfg = jm.MiniLMConfig(**dict(TINY, **over))
    params = jm.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _model(tree, dtype=torch.float32, **over):
    return tm.MiniLM(tm.MiniLMConfig(**dict(TINY, **over)), device="cpu",
                     compute_dtype=dtype).load_params(tm.params_from_jax(tree))


def _jax_tree_of(model) -> dict:
    out: dict = {"embeddings": {}, "layers": {}}
    for key, p in model.leaves():
        g, n = key.split(".", 1)
        out[g][n] = p.detach().numpy().copy()
    return out


def _batch(seed: int, B: int = 8, L: int = 12, neg: bool = False) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    b = {"ids_a": rng.integers(1, 256, (B, L)).astype(np.int32), "mask_a": np.ones((B, L), np.int32),
         "ids_b": rng.integers(1, 256, (B, L)).astype(np.int32), "mask_b": np.ones((B, L), np.int32)}
    b["mask_a"][2, 7:] = 0
    b["ids_a"][2, 7:] = 0
    b["mask_b"][5, 4:] = 0
    b["ids_b"][5, 4:] = 0
    if neg:
        m = np.ones((B, B), bool)
        m[0, 1] = m[1, 0] = m[3, 6] = m[6, 3] = False
        b["neg_mask"] = m
    return b


def _jax_loss_fn(jcfg):
    """The JAX train step's loss at f32 compute."""
    def loss_fn(p, b):
        a = jm.encode(p, b["ids_a"], b["mask_a"], jcfg, compute_dtype=jnp.float32)
        c = jm.encode(p, b["ids_b"], b["mask_b"], jcfg, compute_dtype=jnp.float32)
        return jt.info_nce_loss(a, c, 0.05, b.get("neg_mask"))
    return loss_fn


def _jax_step_fn(jcfg, optimizer):
    """``train.train_step`` with f32 compute (its encode wrapped)."""
    enc32 = functools.partial(jm.encode, compute_dtype=jnp.float32)

    @jax.jit
    def step(params, opt_state, batch):
        orig = jm.encode
        jm.encode = enc32
        try:
            return jt.train_step(params, opt_state, batch, jcfg, optimizer, 0.05)
        finally:
            jm.encode = orig
    return step


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# -- host-side mining, views, masks and batches: bitwise ----------------------


@pytest.mark.parametrize("scrub", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_mine_pairs_equal_jax(scrub, seed):
    docs = _docs() + [["one sentence only"], ["first of two 12", "second of two 34"]]
    assert tt.mine_pairs(docs, seed=seed, scrub_digits=scrub) == jt.mine_pairs(docs, seed=seed, scrub_digits=scrub)


@pytest.mark.parametrize("scrub", [False, True])
def test_augment_view_equal_jax(scrub):
    assert tt.TRAIN_SYNONYM_GROUPS == jt.TRAIN_SYNONYM_GROUPS
    assert tt.TRAIN_SYNONYMS == jt.TRAIN_SYNONYMS and tt._VIEW_STOPWORDS == jt._VIEW_STOPWORDS
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for s in [x for d in _docs(8) for x in d] + ["The Court (judge) held: the lawyer's claim 42."]:
        for kw in ({}, {"swap_prob": 0.5, "drop_prob": 0.9}, {"synonyms": {"court": ["forum"]}}):
            assert tt.augment_view(s, rt, scrub_digits=scrub, **kw) == jt.augment_view(s, rj, scrub_digits=scrub, **kw)


@pytest.mark.parametrize("scrub,views", [(True, 1), (False, 1), (True, 2)])
def test_mine_view_pairs_equal_jax(scrub, views):
    docs = _docs() + [["the of a"]]
    got = tt.mine_view_pairs(docs, seed=1, scrub_digits=scrub, views_per_sentence=views)
    assert got == jt.mine_view_pairs(docs, seed=1, scrub_digits=scrub, views_per_sentence=views)
    assert len(got) > 50


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8])
def test_false_negative_mask_equal_jax(threshold):
    texts = [a + " " + b for a, b in jt.mine_view_pairs(_docs(), seed=2)][:32] + ["", ""]
    got = tt._false_negative_mask(texts, threshold)
    np.testing.assert_array_equal(got, jt._false_negative_mask(texts, threshold))
    assert got.dtype == bool and 0 < (~got).sum() < got.size


@pytest.mark.parametrize("jaccard", [0.0, 0.5])
def test_batches_from_pairs_equal_jax(jaccard):
    """Past one epoch (the reshuffle), with and without ``neg_mask``."""
    docs = _docs()
    jtok, ptok, _ = _tokenizers(docs)
    pairs = jt.mine_view_pairs(docs, seed=0)
    n_batches = len(pairs) // 8 + 3
    jit_ = jt.batches_from_pairs(pairs, jtok, 8, 24, seed=4, false_negative_jaccard=jaccard)
    pit = tt.batches_from_pairs(pairs, ptok, 8, 24, seed=4, false_negative_jaccard=jaccard, device="cpu")
    masked = 0
    for _ in range(n_batches):
        jb, pb = next(jit_), next(pit)
        assert sorted(jb) == sorted(pb)
        for k in jb:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]), err_msg=k)
            assert pb[k].device == torch.device("cpu")
        masked += int((~pb["neg_mask"].numpy()).sum()) if "neg_mask" in pb else 0
    assert ("neg_mask" in pb) == (jaccard > 0) and (masked > 0) == (jaccard > 0)
    assert pb["ids_a"].dtype == torch.int32


# -- the loss, one step, the schedule, the clip, AdamW ------------------------


@pytest.mark.parametrize("case", ["plain", "mask", "all_masked_row", "twins"])
def test_info_nce_loss_equal_jax(case):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = a + 0.3 * rng.standard_normal((8, 16)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    mask = None
    if case == "mask":
        mask = rng.random((8, 8)) > 0.4
    elif case == "all_masked_row":
        mask = np.ones((8, 8), bool)
        mask[2, :] = False  # anchor 2 keeps only its positive
        mask[:, 5] = False
    elif case == "twins":
        a = np.eye(8, 16, dtype=np.float32)
        a[1] = a[0]
        b = a.copy()
        mask = np.ones((8, 8), bool)
        mask[0, 1] = mask[1, 0] = False
    jl, ja = jt.info_nce_loss(jnp.asarray(a), jnp.asarray(b), 0.05,
                              None if mask is None else jnp.asarray(mask))
    tl, ta_ = tt.info_nce_loss(torch.as_tensor(a), torch.as_tensor(b), 0.05,
                               None if mask is None else torch.as_tensor(mask))
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    assert float(ta_) == float(ja)
    if case == "twins":  # masked twins stop costing the loss; the accuracy is perfect
        assert float(ta_) == 1.0 and float(tl) < 0.01


def test_info_nce_accuracy_takes_the_first_index_on_ties():
    a = np.zeros((4, 4), np.float32)
    a[:, 0] = 1.0  # every logit equal
    jl, ja = jt.info_nce_loss(jnp.asarray(a), jnp.asarray(a), 0.05)
    tl, ta_ = tt.info_nce_loss(torch.as_tensor(a), torch.as_tensor(a), 0.05)
    assert float(ta_) == float(ja) == 0.25
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


@pytest.mark.parametrize("neg", [False, True])
def test_one_step_f32_equal_jax(neg):
    jcfg, params, tree = _params()
    model = _model(tree)
    b = _batch(0, neg=neg)
    (jl, jacc), jg = jax.value_and_grad(_jax_loss_fn(jcfg), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    with model.trainable():
        loss, acc = tt.loss_and_grads(model, _tb(b), 0.05)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert float(acc) == float(jacc)
        for key, p in model.leaves():
            g, n = key.split(".", 1)
            want = np.asarray(jg[g][n])
            tol = GRAD_RTOL * float(np.abs(want).max()) + 1e-9
            assert float(np.abs(p.grad.numpy() - want).max()) <= tol, key
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())


@pytest.mark.parametrize("warmup,total", [(100, 1000), (2, 5), (1, 3), (0, 4), (10, 10), (5, 2)])
def test_schedule_factor_equals_optax(warmup, total):
    peak = 2e-4
    sched = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, max(total, warmup + 1))
    for step in range(total + 6):
        want = float(sched(step))
        np.testing.assert_allclose(tt.warmup_cosine_factor(step, warmup, total) * peak, want,
                                   rtol=1e-6, atol=1e-6 * peak, err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [100.0, 0.05])
def test_clip_equals_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) * 0.02 for s in ((4, 8), (8,), (3, 2, 5))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.as_tensor(g.copy()) for g in grads]
    g_norm = tt.clip_by_global_norm_(got, max_norm)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    np.testing.assert_allclose(float(g_norm), norm, rtol=1e-6)
    assert (norm < max_norm) == (max_norm == 100.0)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
        if max_norm == 100.0:
            np.testing.assert_array_equal(g.numpy(), orig)


def _jax_train(jcfg, params, cfg, batches, opt_state=None):
    opt = jt.make_optimizer(cfg)
    opt_state = opt.init(params) if opt_state is None else opt_state
    step = _jax_step_fn(jcfg, opt)
    losses = []
    for b in batches:
        params, opt_state, loss, _ = step(params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return params, opt_state, losses


def _port_train(model, optimizer, batches):
    losses, norms = [], []
    with model.trainable():
        for b in batches:
            loss, _ = tt.loss_and_grads(model, _tb(b), 0.05)
            norms.append(float(optimizer.step()))
            losses.append(float(loss))
    return losses, norms


def _assert_params_close(model, jparams, tol=PARAM_TOL):
    jtree = jax.tree.map(np.asarray, jparams)
    for key, p in model.leaves():
        g, n = key.split(".", 1)
        d = float(np.abs(p.detach().numpy() - jtree[g][n]).max())
        assert d <= tol, (key, d)


#: the test batches' gradient norms lie between 4 and 9 (temperature
#: 0.05), so a limit of 6.5 clips some steps and keeps others
ADAM_CFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5, max_grad_norm=6.5)


def test_adamw_five_steps_equal_optax():
    """Five steps from the same parameters and batches (the first at
    learning rate 0, warmup 2): losses, the clip's norms and the
    parameters; some steps clip and some do not; every leaf moved."""
    jcfg, params, tree = _params()
    cfg_j, cfg_t = jt.TrainConfig(**ADAM_CFG), tt.TrainConfig(**ADAM_CFG)
    batches = [_batch(s, neg=s % 2 == 0) for s in (7, 8, 9, 10, 11)]
    jp, jstate, jlosses = _jax_train(jcfg, params, cfg_j, batches)
    model = _model(tree)
    opt = tt.make_optimizer(cfg_t, model)
    losses, norms = _port_train(model, opt, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert any(n >= cfg_t.max_grad_norm for n in norms) and any(n < cfg_t.max_grad_norm for n in norms)
    _assert_params_close(model, jp)
    for key, p in model.leaves():
        g, n = key.split(".", 1)
        if "k_bias" not in key:  # its gradient is zero in exact arithmetic
            assert not np.array_equal(p.detach().numpy(), tree[g][n]), key
    assert opt.count == 5 and int(jstate[1][2].count) == 5
    jleaves = jax.tree.leaves(jstate)
    pleaves = opt.state_leaves()
    assert len(pleaves) == len(jleaves) == 2 * len(model.leaves()) + 2
    assert pleaves[0].dtype == pleaves[-1].dtype == np.int32
    for i, (a, b) in enumerate(zip(pleaves, jleaves)):  # mu, nu: as the gradients, 1e-4 of the leaf's largest
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()) + 1e-9, err_msg=f"o{i}")


def test_first_step_at_the_schedules_zero_changes_nothing():
    """The schedule starts at 0: the first update leaves every parameter
    as it was, in both packages (Adam term and decay both scaled by it)."""
    jcfg, params, tree = _params()
    model = _model(tree)
    opt = tt.make_optimizer(tt.TrainConfig(warmup_steps=4, total_steps=10), model)
    _port_train(model, opt, [_batch(3)])
    jp, _, _ = _jax_train(jcfg, params, jt.TrainConfig(warmup_steps=4, total_steps=10), [_batch(3)])
    for key, p in model.leaves():
        g, n = key.split(".", 1)
        np.testing.assert_array_equal(p.detach().numpy(), tree[g][n])
        np.testing.assert_array_equal(np.asarray(jp[g][n]), tree[g][n])


# -- optimizer-state checkpoints across the packages --------------------------


def test_jax_checkpoint_with_opt_state_resumes_in_the_port(tmp_path):
    """JAX trains 3 steps and saves with its optax state; the port restores
    both and takes 2 more steps; JAX takes the same 2."""
    jcfg, params, tree = _params()
    cfg = dict(ADAM_CFG)
    batches = [_batch(s, neg=True) for s in (20, 21, 22, 23, 24)]
    jp, jstate, _ = _jax_train(jcfg, params, jt.TrainConfig(**cfg), batches[:3])
    jax_save(tmp_path, 3, jp, opt_state=jstate, metadata={"note": "jax"})
    jp_end, _, _ = _jax_train(jcfg, jp, jt.TrainConfig(**cfg), batches[3:], opt_state=jstate)

    model = _model(tree)
    opt = tt.make_optimizer(tt.TrainConfig(**cfg), model)
    state, meta = restore_checkpoint(tmp_path, tm.MiniLMConfig(**TINY), optimizer=opt)
    assert meta == {"step": 3, "note": "jax"} and opt.count == 3
    model.load_params(state)
    assert opt.adamw.param_groups[0]["lr"] == pytest.approx(
        cfg["learning_rate"] * tt.warmup_cosine_factor(3, 2, 5))
    _port_train(model, opt, batches[3:])
    _assert_params_close(model, jp_end)


def test_port_checkpoint_with_opt_state_resumes_in_jax(tmp_path):
    """The port trains 3 steps and saves with its optimizer; JAX restores
    it through ``opt_state_template`` and takes 2 more; the port the same
    2 from its own restore."""
    jcfg, params, tree = _params()
    cfg = dict(ADAM_CFG)
    batches = [_batch(s) for s in (30, 31, 32, 33, 34)]
    model = _model(tree)
    opt = tt.make_optimizer(tt.TrainConfig(**cfg), model)
    _port_train(model, opt, batches[:3])
    save_checkpoint(tmp_path, 3, model.state_dict(), optimizer=opt, metadata={"note": "port"})
    assert len(np.load(tmp_path / "step_3" / "opt_state.npz").files) == 2 * len(model.leaves()) + 2

    template = jt.make_optimizer(jt.TrainConfig(**cfg)).init(params)
    jp, jstate, meta = jax_restore(tmp_path, params, opt_state_template=template)
    assert meta == {"step": 3, "note": "port"} and int(jstate[1][2].count) == 3
    jp_end, _, _ = _jax_train(jcfg, jp, jt.TrainConfig(**cfg), batches[3:], opt_state=jstate)

    model2 = _model(tree)
    opt2 = tt.make_optimizer(tt.TrainConfig(**cfg), model2)
    state, _ = restore_checkpoint(tmp_path, tm.MiniLMConfig(**TINY), optimizer=opt2)
    model2.load_params(state)
    for (k, a), (_, b) in zip(model.leaves(), model2.leaves()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _port_train(model2, opt2, batches[3:])
    _assert_params_close(model2, jp_end)


def test_checkpoint_without_opt_state_restores_parameters(tmp_path):
    """No ``opt_state.npz``: the parameters restore and the optimizer
    passed in stays as it was (the JAX package returns no optimizer
    state)."""
    jcfg, params, tree = _params()
    model = _model(tree)
    save_checkpoint(tmp_path, 1, model.state_dict())
    assert not (tmp_path / "step_1" / "opt_state.npz").exists()
    opt = tt.make_optimizer(tt.TrainConfig(), model)
    state, _ = restore_checkpoint(tmp_path, tm.MiniLMConfig(**TINY), optimizer=opt)
    assert opt.count == 0 and not opt.adamw.state
    for key, p in model.leaves():
        torch.testing.assert_close(state[key], p.detach(), rtol=0, atol=0)
    jp, jstate, _ = jax_restore(tmp_path, params, opt_state_template=jt.make_optimizer(jt.TrainConfig()).init(params))
    assert jstate is None
    _assert_params_close(model, jp, tol=0.0)


def test_mismatched_opt_state_is_refused(tmp_path):
    from trie_semantic_search_tpu_torch.core.errors import IndexCorrupted

    _, _, tree = _params()
    model = _model(tree)
    opt = tt.make_optimizer(tt.TrainConfig(), model)
    save_checkpoint(tmp_path, 1, model.state_dict(), optimizer=opt)
    other = _model(_params(intermediate_size=32)[2], intermediate_size=32)
    with pytest.raises(IndexCorrupted, match="optimizer"):
        restore_checkpoint(tmp_path, tm.MiniLMConfig(**TINY), optimizer=tt.make_optimizer(tt.TrainConfig(), other))


# -- the pretraining loop and its guardrail -----------------------------------


def _embedders(docs, dtype_f32: bool, seed: int = 0):
    jtok, ptok, n = _tokenizers(docs)
    jcfg, params, tree = _params(seed, vocab_size=max(n, 128))
    mc = JaxEmbeddingModelConfig(max_sequence_length=32)
    jemb = JaxEmbedder(mc, tokenizer=jtok, params=params, model_config=jcfg)
    model = _model(tree, torch.float32 if dtype_f32 else torch.bfloat16, vocab_size=max(n, 128))
    pemb = Embedder(EmbeddingModelConfig(max_sequence_length=32), tokenizer=ptok, model=model, device="cpu")
    return jemb, pemb


_STEP_LINE = re.compile(r"pretrain step (\d+)/(\d+): loss=([\d.]+) acc=([\d.]+)")


def _logged_steps(caplog, logger: str) -> list[tuple[int, float, float]]:
    return [(int(m.group(1)), float(m.group(3)), float(m.group(4)))
            for r in caplog.records if r.name == logger and (m := _STEP_LINE.search(r.getMessage()))]


def test_pretrain_encoder_bf16_loss_trajectory(caplog):
    """12 steps at the defaults' bf16 compute, views with the Jaccard mask
    and scrubbing, logged every step: each loss within ``BF16_LOSS_TOL``
    of the JAX package's, the same report keys."""
    docs = _docs()
    jemb, pemb = _embedders(docs, dtype_f32=False)
    kw = dict(steps=12, batch_size=8, max_len=24, log_every=1, false_negative_jaccard=0.5,
              scrub_digits=True, pair_style="views",
              train_config=None)
    caplog.set_level(logging.INFO)
    jrep = jt.pretrain_encoder(jemb, docs, **dict(kw, train_config=jt.TrainConfig(total_steps=12, warmup_steps=2,
                                                                                  learning_rate=1e-3)))
    prep = tt.pretrain_encoder(pemb, docs, **dict(kw, train_config=tt.TrainConfig(total_steps=12, warmup_steps=2,
                                                                                  learning_rate=1e-3)))
    assert sorted(prep) == sorted(jrep) and prep["steps"] == 12 and prep["pairs"] == jrep["pairs"]
    js, ps = _logged_steps(caplog, "tss_tpu.train"), _logged_steps(caplog, "tss_torch.train")
    assert [s for s, _, _ in ps] == [s for s, _, _ in js] == list(range(1, 13))
    np.testing.assert_allclose([x for _, x, _ in ps], [x for _, x, _ in js], atol=BF16_LOSS_TOL, rtol=0)
    assert ps[-1][1] < ps[0][1]  # it learns
    assert all(not p.requires_grad for p in pemb.model.parameters())


def test_pretrain_skips_tiny_corpus():
    docs = [["one", "two"]]
    jemb, pemb = _embedders(_docs(4), dtype_f32=True)
    for mod, emb in ((jt, jemb), (tt, pemb)):
        assert mod.pretrain_encoder(emb, docs, steps=5, batch_size=32) == {"steps": 0, "pairs": 1}
        # the guarded default mines views: two of the two sentences
        assert mod.pretrain_encoder_guarded(emb, docs, steps=5) == {"steps": 0, "pairs": 2}


def test_guardrail_makes_the_jax_choice_on_the_jax_trained_weights(monkeypatch):
    """The JAX guardrail trains (f32 compute); the port's guardrail gets
    the JAX-trained weights in place of its own training: the same
    choice, the same MRRs, and the embedder holds the weights kept."""
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    docs = _docs()
    jemb, pemb = _embedders(docs, dtype_f32=True)
    init_tree = _jax_tree_of(pemb.model)
    kw = dict(steps=12, batch_size=8, max_len=24, eval_docs=24, eval_probes=24)
    captured = {}
    orig = jt.pretrain_encoder

    def record(emb, *a, **k):
        rep = orig(emb, *a, **k)
        captured["params"], captured["rep"] = jax.tree.map(np.asarray, emb.params), dict(rep)
        return rep

    monkeypatch.setattr(jt, "pretrain_encoder", record)
    jrep = jt.pretrain_encoder_guarded(jemb, docs, train_config=jt.TrainConfig(total_steps=12, warmup_steps=2), **kw)

    def load_jax_trained(emb, *a, **k):
        emb.model.load_params(tm.params_from_jax(captured["params"]))
        return dict(captured["rep"])

    monkeypatch.setattr(tt, "pretrain_encoder", load_jax_trained)
    prep = tt.pretrain_encoder_guarded(pemb, docs, train_config=tt.TrainConfig(total_steps=12, warmup_steps=2), **kw)
    assert prep["guardrail"] == jrep["guardrail"], (prep["guardrail"], jrep["guardrail"])
    kept = captured["params"] if prep["guardrail"]["kept"] == "trained" else init_tree
    for key, p in pemb.model.leaves():
        g, n = key.split(".", 1)
        np.testing.assert_array_equal(p.detach().numpy(), kept[g][n])


def test_guardrail_keeping_init_restores_the_snapshot_bitwise(monkeypatch):
    """Real training moves the weights; when the guardrail keeps
    ``"init"`` (the trained MRR made lower here), every parameter is the
    init's bitwise, not a view of the trained tensors."""
    from trie_semantic_search_tpu_torch.models import quality

    docs = _docs()
    _, pemb = _embedders(docs, dtype_f32=True)
    init = {k: v.clone() for k, v in pemb.model.state_dict().items()}
    real = quality.evaluate_embedder_direct
    seen: list[dict] = []

    def evaluate(emb, *a, **k):
        out = real(emb, *a, **k)
        seen.append({key: v.clone() for key, v in emb.model.state_dict().items()})
        if len(seen) == 1:  # the trained weights: worse than any init
            out["all"] = dict(out["all"], mrr=-1.0)
        return out

    monkeypatch.setattr(tt, "evaluate_embedder_direct", evaluate)
    rep = tt.pretrain_encoder_guarded(pemb, docs, steps=6, batch_size=8, max_len=24, eval_docs=24, eval_probes=24,
                                      train_config=tt.TrainConfig(total_steps=6, warmup_steps=1, learning_rate=1e-2))
    assert rep["guardrail"]["kept"] == "init" and rep["guardrail"]["trained_mrr"] == -1.0
    assert any(not torch.equal(seen[0][k], init[k]) for k in init)  # training moved them
    for k, v in pemb.model.state_dict().items():
        torch.testing.assert_close(v, init[k], rtol=0, atol=0)
        torch.testing.assert_close(seen[1][k], init[k], rtol=0, atol=0)


def test_guardrail_keeps_trained_when_it_is_no_worse(monkeypatch):
    docs = _docs()
    _, pemb = _embedders(docs, dtype_f32=True)
    rep = tt.pretrain_encoder_guarded(pemb, docs, steps=6, batch_size=8, max_len=24, eval_docs=24, eval_probes=24,
                                      train_config=tt.TrainConfig(total_steps=6, warmup_steps=1, learning_rate=1e-3))
    g = rep["guardrail"]
    assert g["kept"] in ("trained", "init") and g["probes"] > 0
    assert (g["kept"] == "trained") == (g["trained_mrr"] >= g["init_mrr"])


# -- pair_ranking_accuracy ------------------------------------------------------


def test_pair_ranking_accuracy_equals_jax(monkeypatch):
    """The case of the JAX package's quality test, f32 compute in both."""
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    subjects = ["miranda warnings", "search warrant", "double jeopardy", "equal protection",
                "takings compensation", "counsel trial", "habeas custody",
                "standing injury", "preemption statute"]
    pairs = [(f"the {s} question arose first", f"the {s} question arose again") for s in subjects]
    vocab = train_wordpiece_vocab([a + " " + b for a, b in pairs], vocab_size=1024, min_frequency=1)
    small = dict(vocab_size=1024, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=32)
    jcfg = jm.MiniLMConfig(**small)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    jemb = JaxEmbedder(JaxEmbeddingModelConfig(), tokenizer=JaxTokenizer(vocab), params=params, model_config=jcfg)
    model = tm.MiniLM(tm.MiniLMConfig(**small), device="cpu", compute_dtype=torch.float32).load_params(
        tm.params_from_jax(jax.tree.map(np.asarray, params)))
    pemb = Embedder(EmbeddingModelConfig(), tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    shuffled = [(pairs[i][0], pairs[(i + 3) % len(pairs)][1]) for i in range(len(pairs))]
    for ps in (pairs, shuffled):
        assert pair_ranking_accuracy(pemb, ps) == jax_pair_ranking_accuracy(jemb, ps)
    assert pair_ranking_accuracy(pemb, pairs) >= 0.75 and pair_ranking_accuracy(pemb, shuffled) <= 0.5


def test_train_step_reduces_loss_on_a_fixed_batch():
    """The JAX package's smoke case: 15 steps on one batch at bf16."""
    _, _, tree = _params()
    model = _model(tree, torch.bfloat16)
    opt = tt.make_optimizer(tt.TrainConfig(total_steps=30, warmup_steps=2, learning_rate=1e-3), model)
    b = _tb(_batch(0))
    losses = []
    with model.trainable():
        for _ in range(15):
            loss, _ = tt.train_step(model, opt, b, 0.05)
            losses.append(float(loss))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


# -- the sharded step (dp × tp over a mesh) -------------------------------------


def test_param_partition_specs_equal_jax():
    """Per leaf of the parameter tree: the dim that shards over ``model``
    is the position of ``"model"`` in the JAX PartitionSpec (none where it
    replicates)."""
    from jax.sharding import PartitionSpec

    cfg = jm.MiniLMConfig(**TINY)
    want = jm.param_partition_specs(cfg)
    got = tm.param_partition_specs(tm.MiniLMConfig(**TINY))
    assert sorted(got) == sorted(want)
    for group, leaves in want.items():
        assert sorted(got[group]) == sorted(leaves), group
        for name, spec in leaves.items():
            assert isinstance(spec, PartitionSpec)
            dim = list(spec).index("model") if "model" in spec else None
            assert got[group][name] == dim, (group, name)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_split_and_join_params_round_trip(mp):
    """Sharded leaves split into equal slices and join back bitwise;
    replicated leaves are the same tensor in every column; a model axis
    that does not divide the heads is refused."""
    _, _, tree = _params()
    state = tm.params_from_jax(tree)
    cfg = tm.MiniLMConfig(**TINY)
    cols = tm.split_params(state, cfg, mp)
    dims = tm.split_dims(cfg)
    for key, t in state.items():
        if dims[key] is None:
            assert all(c[key] is t for c in cols)
        else:
            assert all(c[key].shape[dims[key]] == t.shape[dims[key]] // mp for c in cols)
    back = tm.join_params(cols, cfg)
    assert sorted(back) == sorted(state)
    for key, t in state.items():
        np.testing.assert_array_equal(back[key].numpy(), t.numpy())
    with pytest.raises(ValueError, match="model_parallel 3"):
        tm.split_params(state, cfg, 3)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_tensor_parallel_encoder_equals_the_model(mp):
    """The encoder with its heads and FFN split over ``mp`` columns: one
    column is the model's own function (bitwise); more columns sum the
    partial products in another order (within 1e-6)."""
    _, _, tree = _params()
    model = _model(tree)
    cfg = tm.MiniLMConfig(**TINY)
    b = _tb(_batch(4))
    want = model.encode(b["ids_a"], b["mask_a"])
    with torch.no_grad():
        got = tm.tp_sentence_embeddings(tm.split_params(tm.params_from_jax(tree), cfg, mp), cfg,
                                        b["ids_a"], b["mask_a"], torch.float32)
    if mp == 1:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def _jax_sharded_train(jcfg, params, cfg, batches, dp, mp):
    """The JAX ``make_sharded_train_step`` on its dp × mp CPU mesh, its
    encode at f32 (wrapped while the step traces)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[: dp * mp]).reshape(dp, mp), ("data", "model"))
    opt = jt.make_optimizer(cfg)
    opt_state = opt.init(params)
    step = jt.make_sharded_train_step(mesh, jcfg, opt, 0.05)
    sh = NamedSharding(mesh, P("data", None))
    orig = jm.encode
    jm.encode = functools.partial(orig, compute_dtype=jnp.float32)
    try:
        losses = []
        for b in batches:
            params, opt_state, loss, _ = step(params, opt_state, {k: jax.device_put(jnp.asarray(v), sh)
                                                                  for k, v in b.items()})
            losses.append(float(loss))
    finally:
        jm.encode = orig
    return params, losses


@pytest.mark.parametrize("dp,mp", [(4, 2), (8, 1)])
def test_sharded_step_equals_jax_sharded_step(cpu_devices, dp, mp):
    """The port's sharded step on a dp × mp mesh of ``cpu`` against the
    JAX sharded step on its dp × mp CPU mesh, from the same parameters
    (``params_from_jax`` through ``init_from_jax``) and batches, f32
    compute: the losses within 1e-5 and the parameters after 3 AdamW steps
    within ``PARAM_TOL``."""
    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.parallel import make_mesh

    jcfg, params, tree = _params()
    batches = [_batch(s) for s in (7, 8, 9)]
    cfg = dict(ADAM_CFG, total_steps=3)
    jp, jlosses = _jax_sharded_train(jcfg, params, jt.TrainConfig(**cfg), batches, dp, mp)
    mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices=["cpu"] * (dp * mp))
    step = tt.make_sharded_train_step(mesh, tm.MiniLMConfig(**TINY), tt.TrainConfig(**cfg), 0.05)
    state = step.init_from_jax(tree, compute_dtype=torch.float32)
    losses = [float(step(state, b)[0]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_params_close(step.gather(state, "cpu"), jp)
