"""Device metadata columns for on-device filtering (copy of the JAX
package's ``storage/columns.py``; same artifact format).

The reference applies court / date-range filters on the host after search
(``reference src/search.rs:254-274``). TPU-native design (SURVEY.md §7
"Metadata filters on device"): filterable metadata is frozen into dense
``int32`` device columns aligned with index row ids, so filters become
boolean masks fused into the scoring kernel — no host round-trips, no
dynamic shapes.

Artifacts:
  * ``case_ids``: row → case UUID (host list, for result hydration)
  * ``court_ids``: ``int32[N]`` court-vocabulary id per row
  * ``dates``: ``int32[N]`` decision date as days-since-epoch per row
  * ``court_vocab``: court string → id

A court filter becomes an ``isin``-style mask over a padded id set; a date
range is two integer comparisons.
"""

from __future__ import annotations

import datetime as _dt
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

#: unique identifier of a case (the JAX package's ``core.types.CaseId``)
CaseId = uuid.UUID

_EPOCH = _dt.date(1970, 1, 1)
#: Sentinel for missing dates — far past anything real, excluded by any range.
MISSING_DATE = np.int32(-(10**9))
#: Sentinel court id for rows with no/unknown court.
UNKNOWN_COURT = 0


def date_to_int(d: Optional[_dt.date]) -> int:
    """Date → days since epoch (int32-safe until year ~5,800,000)."""
    if d is None:
        return int(MISSING_DATE)
    return (d - _EPOCH).days


def int_to_date(v: int) -> Optional[_dt.date]:
    if v == int(MISSING_DATE):
        return None
    return _EPOCH + _dt.timedelta(days=int(v))


@dataclass
class MetadataColumns:
    """Frozen filter columns aligned to index row ids."""

    case_ids: list[CaseId] = field(default_factory=list)
    court_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )
    dates: np.ndarray = field(default_factory=lambda: np.zeros((0,), dtype=np.int32))
    court_vocab: dict[str, int] = field(default_factory=dict)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls, rows: Sequence[tuple[str, str, str]]
    ) -> "MetadataColumns":
        """Build from ``(case_id, court, iso_date)`` rows (the shape returned
        by :meth:`StorageManager.fetch_filter_columns`). Row order defines
        the dense row-id space shared with the vector/trie indexes."""
        court_vocab: dict[str, int] = {"": UNKNOWN_COURT}
        case_ids: list[CaseId] = []
        court_ids = np.empty((len(rows),), dtype=np.int32)
        dates = np.empty((len(rows),), dtype=np.int32)
        for i, (cid, court, iso_date) in enumerate(rows):
            case_ids.append(uuid.UUID(cid))
            key = court.strip()
            if key not in court_vocab:
                court_vocab[key] = len(court_vocab)
            court_ids[i] = court_vocab[key]
            if iso_date:
                try:
                    dates[i] = date_to_int(_dt.date.fromisoformat(iso_date))
                except ValueError:
                    dates[i] = MISSING_DATE
            else:
                dates[i] = MISSING_DATE
        return cls(
            case_ids=case_ids,
            court_ids=court_ids,
            dates=dates,
            court_vocab=court_vocab,
        )

    def __len__(self) -> int:
        return len(self.case_ids)

    @property
    def row_of_case(self) -> dict[CaseId, int]:
        if not hasattr(self, "_row_of_case"):
            object.__setattr__(
                self, "_row_of_case", {c: i for i, c in enumerate(self.case_ids)}
            )
        return self._row_of_case  # type: ignore[attr-defined]

    # -- filter encoding ----------------------------------------------------

    def encode_court_filter(
        self, courts: Optional[Sequence[str]], max_courts: int = 16
    ) -> np.ndarray:
        """Court names → fixed-width ``int32[max_courts]`` id set, padded
        with -1 (static shape for jit). Substring semantics intentionally
        NOT used: the reference matched exact court strings
        (search.rs:261-263); exact vocabulary-id match keeps determinism.
        """
        out = np.full((max_courts,), -1, dtype=np.int32)
        if not courts:
            return out
        n = 0
        for c in courts:
            cid = self.court_vocab.get(c.strip())
            if cid is not None and n < max_courts:
                out[n] = cid
                n += 1
        if n == 0:
            # No requested court exists in the vocab → match nothing: use a
            # sentinel id that no row carries (-2).
            out[0] = -2
        return out

    def encode_date_range(
        self,
        date_range: Optional[tuple[Optional[_dt.date], Optional[_dt.date]]],
    ) -> tuple[int, int]:
        """(start, end) dates → inclusive int bounds; None → open bound.

        No filter at all admits everything *including* rows with a missing
        decision date (lo below ``MISSING_DATE``) — parity with the staged
        path, which only applies the mask when a range is given. An explicit
        range with an open start still excludes missing dates: a dateless
        row cannot satisfy a date filter.

        **f32-exactness contract** (the Pallas fused kernel compares dates
        in f32 — int32 broadcast-compares blow Mosaic's scoped VMEM): every
        bound and column value here is exactly representable in f32 with
        order preserved. Real dates are |days| < 2^23; ``MISSING_DATE``
        (-1e9) and ±2^31 are exact; the open-start bound is -(2^24) (NOT
        ``MISSING_DATE + 1``, which rounds to the same f32 as
        ``MISSING_DATE`` and would wrongly admit dateless rows)."""
        if not date_range:
            return (-(2**31), 2**31 - 1)
        start, end = date_range
        lo = date_to_int(start) if start else -(2**24)
        hi = date_to_int(end) if end else 2**31 - 1
        return (lo, hi)

    # -- persistence --------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        courts = list(self.court_vocab.items())
        np.savez_compressed(
            path,
            case_ids=np.array([str(c) for c in self.case_ids]),
            court_ids=self.court_ids,
            dates=self.dates,
            court_names=np.array([k for k, _ in courts]),
            court_vals=np.array([v for _, v in courts], dtype=np.int32),
        )

    @classmethod
    def load(cls, path: str | Path) -> "MetadataColumns":
        with np.load(path, allow_pickle=False) as z:
            vocab = {
                str(k): int(v) for k, v in zip(z["court_names"], z["court_vals"])
            }
            return cls(
                case_ids=[uuid.UUID(str(s)) for s in z["case_ids"]],
                court_ids=z["court_ids"].astype(np.int32),
                dates=z["dates"].astype(np.int32),
                court_vocab=vocab,
            )
