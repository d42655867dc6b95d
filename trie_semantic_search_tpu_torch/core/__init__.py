"""Core layer: domain types, configuration, errors, logging."""

from .config import Config
from .errors import SearchError
from .types import (
    AppState,
    CaseId,
    CaseMetadata,
    DocRef,
    Jurisdiction,
    JurisdictionKind,
    SearchConfig,
    new_case_id,
)

__all__ = [
    "AppState",
    "CaseId",
    "CaseMetadata",
    "Config",
    "DocRef",
    "Jurisdiction",
    "JurisdictionKind",
    "SearchConfig",
    "SearchError",
    "new_case_id",
]
