"""Build-time retrieval-quality gate (port of ``trie_semantic_search_tpu/
index/quality_gate.py``).

Before the artifacts of a build are written, the build's encoder and a
control encoder of the same geometry with random weights are scored on
the same held-out probes over the same chunk sample
(:mod:`..models.quality`); both metric sets persist beside the vector
artifacts (``quality.json``), and an encoder whose probe MRR falls below
``vector.quality_gate_margin`` x the control's is logged (``"warn"``) or
refused (``"refuse"``, :class:`QualityGateFailed`).

The control's weights differ from the JAX package's. There it is
``minilm.init_params(jax.random.PRNGKey(1234), ...)``, whose bits torch
cannot draw; here it is the port's seeded init of the same geometry
(``MiniLM(..., seed=1234)``, a ``torch.Generator``). Both are a random
projection, which is what the gate compares against, but the control MRR,
and with it ``degraded``, can differ between the packages for the same
artifact. ``run_quality_gate(control_factory=...)`` takes any control.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ..core.config import Config
from ..core.errors import ValidationFailed
from ..storage.store import StorageManager
from ..text.processor import TextProcessor

_log = logging.getLogger("tss_torch.quality_gate")

#: artifact-meta filename (written next to the vector artifacts)
QUALITY_META = "quality.json"

#: sentences per sampled case fed to the direct evaluator: bounds the
#: probe corpus so the gate costs seconds, not a re-embed of the build
_CHUNKS_PER_CASE = 8

#: seed of the control encoder's init
CONTROL_SEED = 1234


@dataclass
class QualityGateReport:
    """Probe metrics of the build's encoder and of its control."""

    mode: str  # off | warn | refuse
    degraded: bool = False
    probes: int = 0
    sample_cases: int = 0
    sample_chunks: int = 0
    margin: float = 0.0
    trained: dict = field(default_factory=dict)
    control: dict = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def trained_mrr(self) -> float:
        return float(self.trained.get("all", {}).get("mrr", 0.0))

    @property
    def control_mrr(self) -> float:
        return float(self.control.get("all", {}).get("mrr", 0.0))


class QualityGateFailed(ValidationFailed):
    """``vector.quality_gate = "refuse"`` and the build's encoder scored
    below the margin times its random-weight control."""

    def __init__(self, report: QualityGateReport):
        self.report = report
        super().__init__(
            field="vector.quality_gate",
            reason=(
                f"build encoder probe MRR {report.trained_mrr:.4f} < "
                f"{report.margin:.2f} x random-init control "
                f"{report.control_mrr:.4f} over {report.probes} probes — "
                "refusing to finalize a quality-degraded artifact "
                "(set vector.quality_gate = \"warn\" to override)"
            ),
        )


def _sample_docs(
    storage: StorageManager, tp: TextProcessor, max_cases: int,
) -> tuple[list[tuple[int, list[str]]], list[str], list[int]]:
    """The first ``max_cases`` cases with sentences, in rowid order: their
    sentences (for the probes) and up to :data:`_CHUNKS_PER_CASE` of each
    as the chunk corpus (texts and case rows) the evaluator ranks."""
    docs: list[tuple[int, list[str]]] = []
    chunk_texts: list[str] = []
    chunk_cases: list[int] = []
    for row, meta, text in storage.iter_cases_rowid():
        body = text or meta.full_text
        if not body:
            continue
        sents = tp.extract_sentences(tp.normalize_text(body))
        if not sents:
            continue
        docs.append((row, sents))
        for s in sents[:_CHUNKS_PER_CASE]:
            chunk_texts.append(s)
            chunk_cases.append(row)
        if len(docs) >= max_cases:
            break
    return docs, chunk_texts, chunk_cases


def _control_embedder(config: Config, embedder):
    """The build encoder's tokenizer, geometry and device with the port's
    seeded random weights (:data:`CONTROL_SEED`)."""
    from ..models import minilm
    from ..models.embedder import Embedder

    return Embedder(
        config.vector.model,
        tokenizer=embedder.tokenizer,
        model=minilm.MiniLM(embedder.model_config, device=embedder.device, seed=CONTROL_SEED),
        device=embedder.device,
    )


def run_quality_gate(
    storage: StorageManager,
    config: Config,
    embedder,  # models.embedder.Embedder: the build's encoder
    text_processor: Optional[TextProcessor] = None,
    control_factory: Optional[Callable[[], object]] = None,
) -> Optional[QualityGateReport]:
    """Score the build's encoder against its control; warn or raise
    :class:`QualityGateFailed` on regression per ``vector.quality_gate``.
    None when the gate is off or the corpus is too small for probes (fewer
    than 8 probes or 16 chunks). ``control_factory`` builds the control
    (default: :func:`_control_embedder`)."""
    mode = config.vector.quality_gate
    if mode == "off":
        return None
    t0 = time.perf_counter()
    tp = text_processor or TextProcessor(config.text_processing)
    from ..models.quality import build_probes, evaluate_embedder_direct

    docs, chunk_texts, chunk_cases = _sample_docs(
        storage, tp, config.vector.quality_gate_sample_cases
    )
    probes = build_probes(docs, max_probes=config.vector.quality_gate_probes)
    if len(probes) < 8 or len(chunk_texts) < 16:
        _log.info(
            "quality gate: corpus too small for probes (%d probes / %d "
            "chunks) — skipping", len(probes), len(chunk_texts),
        )
        return None

    trained = evaluate_embedder_direct(embedder, chunk_texts, chunk_cases, probes)
    control_emb = (control_factory or (lambda: _control_embedder(config, embedder)))()
    control = evaluate_embedder_direct(control_emb, chunk_texts, chunk_cases, probes)

    report = QualityGateReport(
        mode=mode,
        probes=len(probes),
        sample_cases=len(docs),
        sample_chunks=len(chunk_texts),
        margin=config.vector.quality_gate_margin,
        trained=trained,
        control=control,
        seconds=round(time.perf_counter() - t0, 2),
    )
    report.degraded = report.trained_mrr < report.margin * report.control_mrr
    _log.info(
        "quality gate: trained MRR %.4f vs control %.4f over %d probes "
        "(%.1fs) — %s",
        report.trained_mrr, report.control_mrr, report.probes,
        report.seconds, "DEGRADED" if report.degraded else "ok",
    )
    if report.degraded:
        if mode == "refuse":
            raise QualityGateFailed(report)
        _log.warning(
            "quality gate: build encoder UNDERPERFORMS its random-init "
            "control (MRR %.4f < %.2f x %.4f) — artifact quality is "
            "degraded; set vector.quality_gate = \"refuse\" to abort "
            "such builds", report.trained_mrr, report.margin,
            report.control_mrr,
        )
    return report


def save_quality_meta(report: Optional[QualityGateReport], vec_dir: Path) -> None:
    """Write the gate's metrics beside the vector artifacts (atomically)."""
    if report is None:
        return
    vec_dir = Path(vec_dir)
    vec_dir.mkdir(parents=True, exist_ok=True)
    tmp = vec_dir / (QUALITY_META + ".tmp")
    tmp.write_text(json.dumps(asdict(report), indent=1))
    tmp.replace(vec_dir / QUALITY_META)


def load_quality_meta(vec_dir: Path) -> Optional[dict]:
    """The persisted gate metrics; None for an artifact without them."""
    p = Path(vec_dir) / QUALITY_META
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return None
