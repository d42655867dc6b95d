"""Core domain types (copy of ``trie_semantic_search_tpu/core/types.py``).

``CaseId``, ``DocRef``, ``Jurisdiction``, ``CaseMetadata`` and
``SearchConfig`` with the same fields, defaults and JSON forms, so a store
or a request written for the JAX package reads the same here. ``AppState``
comes with the HTTP slice.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# CaseId
# ---------------------------------------------------------------------------

#: Unique identifier for legal cases (ref: ``lib.rs:65`` — ``type CaseId = Uuid``).
CaseId = uuid.UUID


def new_case_id() -> CaseId:
    """Mint a fresh case id (UUID4, matching the reference's ``Uuid::new_v4``)."""
    return uuid.uuid4()


def case_id_from_str(s: str) -> CaseId:
    return uuid.UUID(s)


# ---------------------------------------------------------------------------
# DocRef
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class DocRef:
    """Document reference: case id + position (ref: ``lib.rs:68-76``).

    Hashable and order-stable so it can key host-side dedup sets exactly like
    the reference's ``#[derive(Hash, Eq)]`` struct.
    """

    case_id: CaseId
    paragraph_index: int = 0
    char_offset: Optional[int] = None

    def to_json(self) -> dict[str, Any]:
        return {
            "case_id": str(self.case_id),
            "paragraph_index": self.paragraph_index,
            "char_offset": self.char_offset,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "DocRef":
        return cls(
            case_id=uuid.UUID(d["case_id"]),
            paragraph_index=int(d.get("paragraph_index", 0)),
            char_offset=d.get("char_offset"),
        )


# ---------------------------------------------------------------------------
# Jurisdiction
# ---------------------------------------------------------------------------


class JurisdictionKind(str, enum.Enum):
    FEDERAL = "federal"
    STATE = "state"
    LOCAL = "local"
    INTERNATIONAL = "international"


@dataclass(frozen=True, slots=True)
class Jurisdiction:
    """Legal jurisdiction (ref: ``lib.rs:79-85`` — enum with payload for
    ``State(String)`` / ``Local(String)``)."""

    kind: JurisdictionKind
    name: Optional[str] = None  # payload for STATE / LOCAL

    # Convenience constructors mirroring the Rust enum variants.
    @classmethod
    def federal(cls) -> "Jurisdiction":
        return cls(JurisdictionKind.FEDERAL)

    @classmethod
    def state(cls, name: str) -> "Jurisdiction":
        return cls(JurisdictionKind.STATE, name)

    @classmethod
    def local(cls, name: str) -> "Jurisdiction":
        return cls(JurisdictionKind.LOCAL, name)

    @classmethod
    def international(cls) -> "Jurisdiction":
        return cls(JurisdictionKind.INTERNATIONAL)

    def to_json(self) -> dict[str, Any]:
        return {"kind": self.kind.value, "name": self.name}

    @classmethod
    def from_json(cls, d: Any) -> "Jurisdiction":
        if isinstance(d, str):
            return cls(JurisdictionKind(d))
        return cls(JurisdictionKind(d["kind"]), d.get("name"))


# ---------------------------------------------------------------------------
# CaseMetadata
# ---------------------------------------------------------------------------


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass(slots=True)
class CaseMetadata:
    """Case metadata, all 15 reference fields (ref: ``lib.rs:87-118``)."""

    id: CaseId
    name: str
    citation: str
    court: str
    decision_date: _dt.date
    judges: list[str] = field(default_factory=list)
    topics: list[str] = field(default_factory=list)
    full_text: str = ""
    jurisdiction: Jurisdiction = field(default_factory=Jurisdiction.federal)
    citations: list[str] = field(default_factory=list)
    docket_number: Optional[str] = None
    source_url: Optional[str] = None
    word_count: int = 0
    ingestion_date: _dt.datetime = field(default_factory=_utcnow)

    def to_json(self) -> dict[str, Any]:
        return {
            "id": str(self.id),
            "name": self.name,
            "citation": self.citation,
            "court": self.court,
            "decision_date": self.decision_date.isoformat(),
            "judges": list(self.judges),
            "topics": list(self.topics),
            "full_text": self.full_text,
            "jurisdiction": self.jurisdiction.to_json(),
            "citations": list(self.citations),
            "docket_number": self.docket_number,
            "source_url": self.source_url,
            "word_count": self.word_count,
            "ingestion_date": self.ingestion_date.isoformat(),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CaseMetadata":
        return cls(
            id=uuid.UUID(d["id"]),
            name=d["name"],
            citation=d.get("citation", ""),
            court=d.get("court", ""),
            decision_date=_dt.date.fromisoformat(d["decision_date"]),
            judges=list(d.get("judges", [])),
            topics=list(d.get("topics", [])),
            full_text=d.get("full_text", ""),
            jurisdiction=Jurisdiction.from_json(d.get("jurisdiction", "federal")),
            citations=list(d.get("citations", [])),
            docket_number=d.get("docket_number"),
            source_url=d.get("source_url"),
            word_count=int(d.get("word_count", 0)),
            ingestion_date=_dt.datetime.fromisoformat(d["ingestion_date"])
            if d.get("ingestion_date")
            else _utcnow(),
        )


# ---------------------------------------------------------------------------
# SearchConfig
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class SearchConfig:
    """Per-query search behaviour (ref: ``lib.rs:120-145``; defaults
    ``lib.rs:135-145``)."""

    max_results: int = 10
    min_similarity: float = 0.5
    exact_match_weight: float = 2.0
    enable_semantic: bool = True
    enable_prefix: bool = True

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "SearchConfig":
        return cls(**{k: d[k] for k in d if k in cls.__dataclass_fields__})
