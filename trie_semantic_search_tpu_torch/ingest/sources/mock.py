"""In-memory mock data source, the pipeline's network-free fixture (copy
of ``trie_semantic_search_tpu/ingest/sources/mock.py``): three landmark
cases by default, or the ``cases`` it is given."""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

from ...core.types import CaseMetadata, Jurisdiction, new_case_id
from .base import CasePayload, DataSource, SourceHealth, SourceInfo

_LANDMARK_CASES: list[tuple[str, str, str, _dt.date, str]] = [
    (
        "Brown v. Board of Education",
        "347 U.S. 483 (1954)",
        "Supreme Court of the United States",
        _dt.date(1954, 5, 17),
        "We come then to the question presented: Does segregation of children "
        "in public schools solely on the basis of race deprive the children "
        "of the minority group of equal educational opportunities? We believe "
        "that it does. We conclude that in the field of public education the "
        "doctrine of separate but equal has no place. Separate educational "
        "facilities are inherently unequal.",
    ),
    (
        "Miranda v. Arizona",
        "384 U.S. 436 (1966)",
        "Supreme Court of the United States",
        _dt.date(1966, 6, 13),
        "The person in custody must, prior to interrogation, be clearly "
        "informed that he has the right to remain silent, and that anything "
        "he says will be used against him in court. He must be clearly "
        "informed that he has the right to consult with a lawyer and to have "
        "the lawyer with him during interrogation.",
    ),
    (
        "Roe v. Wade",
        "410 U.S. 113 (1973)",
        "Supreme Court of the United States",
        _dt.date(1973, 1, 22),
        "This right of privacy, whether it be founded in the Fourteenth "
        "Amendment's concept of personal liberty and restrictions upon state "
        "action, as we feel it is, or in the Ninth Amendment's reservation "
        "of rights to the people, is broad enough to encompass a woman's "
        "decision whether or not to terminate her pregnancy.",
    ),
]


class MockDataSource(DataSource):
    """Deterministic fixture source; optionally seeded with custom cases."""

    def __init__(self, cases: Optional[Sequence[CasePayload]] = None, healthy: bool = True):
        super().__init__()
        if cases is not None:
            self._cases = list(cases)
        else:
            self._cases = []
            for name, cit, court, date, text in _LANDMARK_CASES:
                meta = CaseMetadata(
                    id=new_case_id(),
                    name=name,
                    citation=cit,
                    court=court,
                    decision_date=date,
                    jurisdiction=Jurisdiction.federal(),
                    citations=[cit],
                    word_count=len(text.split()),
                )
                self._cases.append((meta, text))
        self._healthy = healthy

    @property
    def name(self) -> str:
        return "mock"

    def get_source_info(self) -> SourceInfo:
        return SourceInfo(
            name="mock",
            description="In-memory mock source (3 landmark SCOTUS cases)",
            supports_incremental=False,
        )

    async def health_check(self) -> SourceHealth:
        return SourceHealth(
            healthy=self._healthy,
            message="mock source" if self._healthy else "mock source forced down",
            last_check=_dt.datetime.now(_dt.timezone.utc),
            response_time_ms=0.0,
        )

    async def fetch_cases(self, limit: Optional[int] = None) -> list[CasePayload]:
        self.stats.requests_made += 1
        out = self._cases[:limit] if limit is not None else list(self._cases)
        self.stats.cases_fetched += len(out)
        self.stats.last_fetch = _dt.datetime.now(_dt.timezone.utc)
        return out

    async def fetch_case(self, case_id: str) -> Optional[CasePayload]:
        for meta, text in self._cases:
            if str(meta.id) == case_id:
                return meta, text
        return None

    async def list_available_cases(self, limit: Optional[int] = None) -> list[str]:
        ids = [str(m.id) for m, _ in self._cases]
        return ids[:limit] if limit else ids
