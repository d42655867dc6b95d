"""Case validation rules (copy of ``trie_semantic_search_tpu/ingest/
validation.py``): text length bounds, required fields, citation format and
date sanity, each issue graded by severity; CRITICAL and HIGH issues fail
the case, MEDIUM and LOW ones are warnings.
"""

from __future__ import annotations

import abc
import datetime as _dt
import enum
from dataclasses import dataclass, field
from typing import Optional

from ..core.config import ValidationConfig
from ..core.types import CaseMetadata
from ..utils import ValidationUtils


class ValidationSeverity(str, enum.Enum):
    CRITICAL = "critical"
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


@dataclass
class ValidationIssue:
    rule: str
    message: str
    severity: ValidationSeverity


@dataclass
class ValidationResult:
    """``passed`` until a CRITICAL or HIGH issue is added."""

    passed: bool = True
    errors: list[ValidationIssue] = field(default_factory=list)
    warnings: list[ValidationIssue] = field(default_factory=list)

    def add(self, issue: ValidationIssue) -> None:
        if issue.severity in (ValidationSeverity.CRITICAL, ValidationSeverity.HIGH):
            self.errors.append(issue)
            self.passed = False
        else:
            self.warnings.append(issue)


class ValidationRule(abc.ABC):
    name: str = "rule"

    @abc.abstractmethod
    def check(self, metadata: CaseMetadata, text: str) -> Optional[ValidationIssue]: ...


class TextLengthRule(ValidationRule):
    name = "text_length"

    def __init__(self, min_len: int, max_len: int):
        self.min_len = min_len
        self.max_len = max_len

    def check(self, metadata: CaseMetadata, text: str) -> Optional[ValidationIssue]:
        n = len(text)
        if n < self.min_len:
            return ValidationIssue(
                self.name, f"text too short: {n} < {self.min_len}", ValidationSeverity.HIGH
            )
        if n > self.max_len:
            return ValidationIssue(
                self.name, f"text too long: {n} > {self.max_len}", ValidationSeverity.HIGH
            )
        return None


class RequiredFieldsRule(ValidationRule):
    name = "required_fields"

    #: config field name → metadata accessor
    _FIELDS = {
        "title": lambda m: m.name,
        "case_name": lambda m: m.name,
        "date": lambda m: m.decision_date,
        "court": lambda m: m.court,
        "citation": lambda m: m.citation,
    }

    def __init__(self, required: list[str]):
        self.required = required

    def check(self, metadata: CaseMetadata, text: str) -> Optional[ValidationIssue]:
        missing = []
        for f in self.required:
            getter = self._FIELDS.get(f)
            if getter is None:
                continue
            v = getter(metadata)
            if v is None or (isinstance(v, str) and not v.strip()):
                missing.append(f)
        if missing:
            return ValidationIssue(
                self.name,
                f"missing required fields: {', '.join(missing)}",
                ValidationSeverity.CRITICAL,
            )
        return None


class CitationFormatRule(ValidationRule):
    name = "citation_format"

    def __init__(self, allow_empty: bool):
        self.allow_empty = allow_empty

    def check(self, metadata: CaseMetadata, text: str) -> Optional[ValidationIssue]:
        if not metadata.citation:
            if self.allow_empty:
                return None
            return ValidationIssue(self.name, "empty citation", ValidationSeverity.MEDIUM)
        if not ValidationUtils.is_valid_citation(metadata.citation):
            return ValidationIssue(
                self.name,
                f"citation does not match volume-reporter-page(year): {metadata.citation!r}",
                ValidationSeverity.LOW,
            )
        return None


class DateSanityRule(ValidationRule):
    name = "date_sanity"

    #: earliest plausible US case law
    _MIN_DATE = _dt.date(1600, 1, 1)

    def check(self, metadata: CaseMetadata, text: str) -> Optional[ValidationIssue]:
        d = metadata.decision_date
        if d < self._MIN_DATE:
            return ValidationIssue(
                self.name, f"decision date implausibly old: {d}", ValidationSeverity.HIGH
            )
        if d > _dt.date.today():
            return ValidationIssue(
                self.name, f"decision date in the future: {d}", ValidationSeverity.HIGH
            )
        return None


class CaseValidator:
    """The configured rules, in the JAX package's order."""

    def __init__(self, config: Optional[ValidationConfig] = None):
        self.config = config or ValidationConfig()
        self.rules: list[ValidationRule] = [
            TextLengthRule(self.config.min_text_length, self.config.max_text_length),
            RequiredFieldsRule(self.config.required_fields),
        ]
        if self.config.validate_citations:
            self.rules.append(CitationFormatRule(self.config.allow_empty_citations))
        if self.config.validate_dates:
            self.rules.append(DateSanityRule())

    def validate_case(self, metadata: CaseMetadata, text: str) -> ValidationResult:
        result = ValidationResult()
        for rule in self.rules:
            issue = rule.check(metadata, text)
            if issue is not None:
                result.add(issue)
        return result

    def validate(self, metadata: CaseMetadata) -> ValidationResult:
        return self.validate_case(metadata, metadata.full_text)
