"""Encoder training (port of ``trie_semantic_search_tpu/models/train.py``).

For now this module holds :func:`select_pooling_guarded`, which trains
nothing: it counts token ids, derives SIF weights and keeps mean or SIF
pooling on probe merit, and both builds call it for ``vector.pooling``
``"auto"`` and ``"sif"``. The rest of the JAX module (the optimizer,
InfoNCE, the train step, pair mining and the guarded pretraining) comes
with ``ROADMAP.md`` §1 slice 4 (training).
"""

from __future__ import annotations

import itertools
import logging
from typing import Optional, Sequence

from .minilm import count_token_ids, sif_weights_from_counts
from .quality import build_probes, evaluate_embedder_direct

_log = logging.getLogger("tss_torch.train")


def select_pooling_guarded(
    embedder,  # models.embedder.Embedder (its token weights are set in place)
    docs: Sequence[Sequence[str]],
    sif_a: float = 0.1,
    eval_docs: int = 64,
    eval_probes: int = 96,
    count_sentences: int = 50_000,
    force: Optional[str] = None,  # "mean" | "sif" skips the comparison
) -> dict:
    """Pick the pooling on probe merit and leave the winner on the
    embedder: SIF weights from a tokenize-only count over at most
    ``count_sentences`` sentences of ``docs``, then the encoder under mean
    and under SIF pooling on held-out probes (:func:`.quality.build_probes`
    over the first ``eval_docs`` documents, each scored by
    :func:`.quality.evaluate_embedder_direct` over their first eight
    sentences); SIF is kept only when its MRR is higher. Mean pooling
    without a comparison when fewer than 8 probes come out. Returns what
    was picked and both MRRs."""
    counts = count_token_ids(
        embedder.tokenizer,
        itertools.islice((s for sents in docs for s in sents), count_sentences),
        vocab_size=max(len(embedder.tokenizer), 128),
    )
    weights = sif_weights_from_counts(counts, a=sif_a)
    if force == "sif":
        embedder.set_token_weights(weights)
        return {"pooling": "sif", "sif_a": sif_a, "forced": True}
    if force == "mean":
        embedder.set_token_weights(None)
        return {"pooling": "mean", "forced": True}

    sample = list(enumerate(docs[:eval_docs]))
    probes = build_probes(sample, max_probes=eval_probes)
    texts: list[str] = []
    rows: list[int] = []
    for i, sents in sample:
        for s in sents[:8]:
            texts.append(s)
            rows.append(i)
    if len(probes) < 8 or not texts:
        embedder.set_token_weights(None)
        return {"pooling": "mean", "reason": "corpus too small for probes"}
    embedder.set_token_weights(None)
    mean_m = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    embedder.set_token_weights(weights)
    sif_m = evaluate_embedder_direct(embedder, texts, rows, probes)["all"]
    if sif_m["mrr"] > mean_m["mrr"]:
        kept = "sif"  # its weights are set already
    else:
        kept = "mean"
        embedder.set_token_weights(None)
    rec = {
        "pooling": kept, "sif_a": sif_a,
        "mean_mrr": mean_m["mrr"], "sif_mrr": sif_m["mrr"],
        "probes": len(probes),
    }
    _log.info("pooling selection: %s", rec)
    return rec
