"""Legal text processing pipeline (copy of ``trie_semantic_search_tpu/
text/processor.py``, line for line in behaviour).

NFC normalisation and whitespace/quote/control cleanup, the word
tokenizer, sentence splitting with the configured length bounds, citation,
legal-term and entity extraction, and text statistics. The search engine
replays ``normalize_text`` → ``extract_sentences`` on a stored case text to
find the sentence a semantic hit matched, so the output here must equal
the JAX package's character for character (tested).
"""

from __future__ import annotations

import enum
import re
import unicodedata
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.config import TextProcessingConfig

# ---------------------------------------------------------------------------
# Result dataclasses (ref: text_processing.rs:38-193)
# ---------------------------------------------------------------------------


class TokenType(str, enum.Enum):
    WORD = "word"
    NUMBER = "number"
    PUNCTUATION = "punctuation"
    CITATION = "citation"
    LEGAL_TERM = "legal_term"
    PROPER_NOUN = "proper_noun"
    OTHER = "other"


@dataclass(slots=True)
class Token:
    text: str
    normalized: str
    position: int
    token_type: TokenType
    is_stopword: bool
    pos_tag: Optional[str] = None


class CitationType(str, enum.Enum):
    CASE = "case"
    STATUTE = "statute"
    REGULATION = "regulation"
    CONSTITUTIONAL = "constitutional"
    SECONDARY = "secondary"
    UNKNOWN = "unknown"


@dataclass(slots=True)
class Citation:
    full_text: str
    normalized: str
    citation_type: CitationType
    volume: Optional[str] = None
    reporter: Optional[str] = None
    page: Optional[str] = None
    year: Optional[int] = None
    position: int = 0


class LegalTermCategory(str, enum.Enum):
    PROCEDURE = "procedure"
    EVIDENCE = "evidence"
    CONTRACT = "contract"
    CRIMINAL = "criminal"
    CONSTITUTIONAL = "constitutional"
    TORT = "tort"
    PROPERTY = "property"
    CORPORATE = "corporate"
    FAMILY = "family"
    TAX = "tax"
    OTHER = "other"


@dataclass(slots=True)
class LegalTerm:
    term: str
    category: LegalTermCategory
    confidence: float
    position: int


class EntityType(str, enum.Enum):
    PERSON = "person"
    COURT = "court"
    JUDGE = "judge"
    ATTORNEY = "attorney"
    PARTY = "party"
    ORGANIZATION = "organization"
    LOCATION = "location"
    DATE = "date"
    MONEY = "money"
    OTHER = "other"


@dataclass(slots=True)
class NamedEntity:
    text: str
    entity_type: EntityType
    confidence: float
    position: int


@dataclass(slots=True)
class TextStats:
    char_count: int = 0
    word_count: int = 0
    sentence_count: int = 0
    paragraph_count: int = 0
    unique_words: int = 0
    reading_level: Optional[float] = None
    language: Optional[str] = None


@dataclass(slots=True)
class ProcessedText:
    original: str
    normalized: str
    tokens: list[Token] = field(default_factory=list)
    sentences: list[str] = field(default_factory=list)
    citations: list[Citation] = field(default_factory=list)
    legal_terms: list[LegalTerm] = field(default_factory=list)
    entities: list[NamedEntity] = field(default_factory=list)
    stats: TextStats = field(default_factory=TextStats)


# ---------------------------------------------------------------------------
# Dictionaries (ref: text_processing.rs:313-372)
# ---------------------------------------------------------------------------

_LEGAL_TERMS: tuple[str, ...] = (
    # Procedure
    "motion", "petition", "complaint", "answer", "discovery", "deposition",
    "subpoena", "summons", "jurisdiction", "venue", "standing", "joinder",
    # Evidence
    "hearsay", "objection", "sustained", "overruled", "exhibit", "testimony",
    "witness", "cross-examination", "direct examination", "impeachment",
    # Criminal
    "indictment", "arraignment", "plea", "guilty", "not guilty", "felony",
    "misdemeanor", "sentence", "probation", "parole", "bail", "warrant",
    # Constitutional
    "due process", "equal protection", "first amendment", "fourth amendment",
    "search and seizure", "miranda", "habeas corpus", "constitutional",
    # Contract
    "consideration", "breach", "damages", "specific performance", "contract",
    "agreement", "offer", "acceptance", "counteroffer", "rescission",
    # Tort
    "negligence", "liability", "causation", "duty",
    "proximate cause", "strict liability", "intentional tort", "defamation",
    # Property
    "title", "deed", "easement", "lien", "mortgage", "foreclosure",
    "adverse possession", "eminent domain", "zoning", "covenant",
)

_STOPWORDS: frozenset[str] = frozenset(
    """a an and are as at be by for from has he in is it its of on that the
    to was will with this but they have had what said each which she do how
    their if up out many then them these so some her would make like into him
    time two more go no way could my than first been call who oil sit now
    find down day did get come made may part""".split()
)

# Term → category (ref: classify_legal_term, text_processing.rs:610-622)
_TERM_CATEGORY: dict[str, LegalTermCategory] = {}
for _t in ("motion", "petition", "complaint", "discovery"):
    _TERM_CATEGORY[_t] = LegalTermCategory.PROCEDURE
for _t in ("hearsay", "objection", "testimony", "exhibit"):
    _TERM_CATEGORY[_t] = LegalTermCategory.EVIDENCE
for _t in ("indictment", "guilty", "felony", "sentence"):
    _TERM_CATEGORY[_t] = LegalTermCategory.CRIMINAL
for _t in ("due process", "constitutional", "amendment"):
    _TERM_CATEGORY[_t] = LegalTermCategory.CONSTITUTIONAL
for _t in ("contract", "breach", "damages", "consideration"):
    _TERM_CATEGORY[_t] = LegalTermCategory.CONTRACT
for _t in ("negligence", "liability", "tort", "causation"):
    _TERM_CATEGORY[_t] = LegalTermCategory.TORT
for _t in ("title", "deed", "property", "easement"):
    _TERM_CATEGORY[_t] = LegalTermCategory.PROPERTY


# ---------------------------------------------------------------------------
# Patterns (ref: text_processing.rs:252-309)
# ---------------------------------------------------------------------------

# Each entry: (compiled regex, group-name layout). Named groups fix the
# reference's one-layout-fits-all capture bug.
_CITATION_PATTERNS: tuple[re.Pattern[str], ...] = (
    # U.S. Reports: 347 U.S. 483 (1954)  [checked before the generic pattern]
    re.compile(r"(?P<volume>\d+)\s+(?P<reporter>U\.S\.)\s+(?P<page>\d+)(?:\s*\((?P<year>\d{4})\))?"),
    # Federal reporters: 123 F.2d 456 (9th Cir. 1987)
    re.compile(r"(?P<volume>\d+)\s+(?P<reporter>F\.\s*(?:2d|3d))\s+(?P<page>\d+)\s*\([^)]*(?P<year>\d{4})\)"),
    # Supreme Court Reporter: 86 S. Ct. 1602 (1966)
    re.compile(r"(?P<volume>\d+)\s+(?P<reporter>S\.\s*Ct\.)\s+(?P<page>\d+)(?:\s*\((?P<year>\d{4})\))?"),
    # State reporters with series: 12 Cal. 3d 456 (Cal. 1990)
    re.compile(r"(?P<volume>\d+)\s+(?P<reporter>[A-Z][a-z]*\.?\s*(?:2d|3d)?)\s+(?P<page>\d+)\s*\([^)]*(?P<year>\d{4})\)"),
    # Generic Volume Reporter Page (Year)
    re.compile(r"(?P<volume>\d+)\s+(?P<reporter>[A-Z][a-z]*\.?\s*[A-Z]*\.?)\s+(?P<page>\d+)(?:\s*\((?P<year>\d{4})\))?"),
)

_COURT_PATTERNS: tuple[re.Pattern[str], ...] = tuple(
    re.compile(p, re.IGNORECASE)
    for p in (
        r"supreme\s+court",
        r"court\s+of\s+appeals",
        r"district\s+court",
        r"circuit\s+court",
        r"bankruptcy\s+court",
        r"magistrate\s+judge",
    )
)

_JUDGE_PATTERNS: tuple[re.Pattern[str], ...] = tuple(
    re.compile(p)
    for p in (
        r"(?i:chief\s+judge)\s+(?P<name>[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*)",
        r"(?i:magistrate\s+judge)\s+(?P<name>[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*)",
        r"(?i:judge)\s+(?P<name>[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*)",
        r"(?i:justice)\s+(?P<name>[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*)",
    )
)

_DATE_PATTERN = re.compile(r"\b\d{1,2}/\d{1,2}/\d{4}\b|\b\d{4}\b")
_WORD_PATTERN = re.compile(r"\b\w+\b", re.UNICODE)
_SENTENCE_SPLIT = re.compile(r"[.!?]+\s+")
_WS_COLLAPSE = re.compile(r"\s+")

_QUOTE_MAP = str.maketrans({
    "“": '"', "”": '"',  # curly double quotes
    "‘": "'", "’": "'",  # curly single quotes
})


class _CtrlDeleteTable(dict):
    """``str.translate`` table deleting category-C codepoints (except
    ``\\n``/``\\t``) — identical semantics to the previous per-character
    ``unicodedata.category`` generator, but after the first sighting of a
    codepoint every later occurrence is a C-level dict hit. The per-char
    Python loop was the single hottest host cost in the round-5 serving
    profile (~43% of a 64-query batch's hydration wall)."""

    def __missing__(self, cp: int):
        ch = chr(cp)
        keep = ch in ("\n", "\t") or not unicodedata.category(ch).startswith("C")
        v = cp if keep else None
        self[cp] = v
        return v


_CTRL_DELETE = _CtrlDeleteTable()


def count_syllables(word: str) -> int:
    """Vowel-run syllable approximation (ref: text_processing.rs:624-650)."""
    w = word.lower()
    vowels = "aeiouy"
    count = 0
    prev = False
    for ch in w:
        is_v = ch in vowels
        if is_v and not prev:
            count += 1
        prev = is_v
    if w.endswith("e") and count > 1:
        count -= 1
    return max(count, 1)


class TextProcessor:
    """Host-side legal text processing pipeline (ref:
    ``text_processing.rs:195-681``)."""

    def __init__(self, config: Optional[TextProcessingConfig] = None):
        self.config = config or TextProcessingConfig()
        self.legal_terms = frozenset(t.lower() for t in _LEGAL_TERMS)
        self.stopwords = _STOPWORDS

    # -- pipeline -----------------------------------------------------------

    def process_text(self, text: str) -> ProcessedText:
        """Full pipeline: normalize → tokenize → sentences → citations →
        terms → entities → stats (ref: ``process_text``, 215-249)."""
        normalized = self.normalize_text(text)
        tokens = self.tokenize(normalized)
        sentences = self.extract_sentences(normalized)
        citations = (
            self.extract_citations(normalized)
            if self.config.extract_citations
            else []
        )
        legal_terms = self.extract_legal_terms(tokens)
        entities = (
            self.extract_entities(normalized) if self.config.extract_entities else []
        )
        stats = self.calculate_stats(normalized, tokens, sentences, original=text)
        return ProcessedText(
            original=text,
            normalized=normalized,
            tokens=tokens,
            sentences=sentences,
            citations=citations,
            legal_terms=legal_terms,
            entities=entities,
            stats=stats,
        )

    # -- stages -------------------------------------------------------------

    def normalize_text(self, text: str) -> str:
        """NFC + whitespace/quote/control cleanup (ref 375-402)."""
        normalized = text
        if self.config.enable_unicode_normalization:
            normalized = unicodedata.normalize("NFC", normalized)
        if self.config.remove_extra_whitespace:
            normalized = _WS_COLLAPSE.sub(" ", normalized)
        if self.config.normalize_quotes:
            normalized = normalized.translate(_QUOTE_MAP)
        # Drop control chars but preserve \n and \t (ref 396-399) — one
        # C-level translate pass over a self-caching category-C table.
        normalized = normalized.translate(_CTRL_DELETE)
        return normalized.strip()

    def tokenize(self, text: str) -> list[Token]:
        """Word-regex tokenizer with typing + stopword flags (ref 405-435)."""
        tokens: list[Token] = []
        for m in _WORD_PATTERN.finditer(text):
            word = m.group(0)
            normalized = word.lower() if self.config.enable_case_folding else word
            lowered = word.lower()
            is_stop = lowered in self.stopwords
            if lowered in self.legal_terms:
                ttype = TokenType.LEGAL_TERM
            elif word.isdigit():
                ttype = TokenType.NUMBER
            elif word[:1].isupper():
                ttype = TokenType.PROPER_NOUN
            else:
                ttype = TokenType.WORD
            tokens.append(
                Token(
                    text=word,
                    normalized=normalized,
                    position=m.start(),
                    token_type=ttype,
                    is_stopword=is_stop,
                )
            )
        return tokens

    def extract_sentences(self, text: str) -> list[str]:
        """Split on sentence-final punctuation runs (ref 438-448), then apply
        the configured length bounds (config.rs:168-176 — the reference
        declared but never applied them)."""
        if not self.config.sentence_splitting.enabled:
            return [text] if text else []
        parts = [s.strip() for s in _SENTENCE_SPLIT.split(text)]
        sentences = [s for s in parts if s]
        lo = self.config.sentence_splitting.min_sentence_length
        hi = self.config.sentence_splitting.max_sentence_length
        out: list[str] = []
        for s in sentences:
            if len(s) < lo:
                continue
            while len(s) > hi:  # hard-wrap over-long sentences
                out.append(s[:hi])
                s = s[hi:]
            if s:
                out.append(s)
        return out or sentences  # never lose everything on tiny inputs

    def extract_citations(self, text: str) -> list[Citation]:
        """Structured citation extraction with dedup (ref 451-478)."""
        found: list[Citation] = []
        for rx in _CITATION_PATTERNS:
            for m in rx.finditer(text):
                year = m.groupdict().get("year")
                found.append(
                    Citation(
                        full_text=m.group(0),
                        normalized=self.normalize_citation(m.group(0)),
                        citation_type=self.classify_citation(m.group(0)),
                        volume=m.groupdict().get("volume"),
                        reporter=(m.groupdict().get("reporter") or "").strip() or None,
                        page=m.groupdict().get("page"),
                        year=int(year) if year else None,
                        position=m.start(),
                    )
                )
        found.sort(key=lambda c: c.position)
        seen: set[str] = set()
        out: list[Citation] = []
        for c in found:
            if c.normalized not in seen:
                seen.add(c.normalized)
                out.append(c)
        return out

    def extract_legal_terms(self, tokens: Sequence[Token]) -> list[LegalTerm]:
        """Dictionary legal-term recognition (ref 481-497); also catches the
        multi-word dictionary entries by scanning bigrams."""
        terms: list[LegalTerm] = []
        for tok in tokens:
            if tok.token_type == TokenType.LEGAL_TERM:
                terms.append(
                    LegalTerm(
                        term=tok.text,
                        category=self.classify_legal_term(tok.text.lower()),
                        confidence=0.8,
                        position=tok.position,
                    )
                )
        # Multi-word terms ("due process", "habeas corpus", ...)
        for i in range(len(tokens) - 1):
            bigram = f"{tokens[i].text.lower()} {tokens[i + 1].text.lower()}"
            if bigram in self.legal_terms:
                terms.append(
                    LegalTerm(
                        term=f"{tokens[i].text} {tokens[i + 1].text}",
                        category=self.classify_legal_term(bigram),
                        confidence=0.8,
                        position=tokens[i].position,
                    )
                )
        terms.sort(key=lambda t: t.position)
        return terms

    def extract_entities(self, text: str) -> list[NamedEntity]:
        """Regex NER: judges, courts, dates (ref 500-541)."""
        entities: list[NamedEntity] = []
        for rx in _JUDGE_PATTERNS:
            for m in rx.finditer(text):
                entities.append(
                    NamedEntity(
                        text=m.group(0),
                        entity_type=EntityType.JUDGE,
                        confidence=0.9,
                        position=m.start(),
                    )
                )
        for rx in _COURT_PATTERNS:
            for m in rx.finditer(text):
                entities.append(
                    NamedEntity(
                        text=m.group(0),
                        entity_type=EntityType.COURT,
                        confidence=0.85,
                        position=m.start(),
                    )
                )
        for m in _DATE_PATTERN.finditer(text):
            entities.append(
                NamedEntity(
                    text=m.group(0),
                    entity_type=EntityType.DATE,
                    confidence=0.7,
                    position=m.start(),
                )
            )
        return entities

    def calculate_stats(
        self, text: str, tokens: Sequence[Token], sentences: Sequence[str],
        original: Optional[str] = None,
    ) -> TextStats:
        """Counts + Flesch reading ease (ref 544-581). Paragraph breaks are
        counted on the ORIGINAL text: whitespace collapse in normalisation
        removes every \n\n, so counting on normalised text always gave 1
        (the reference had the same defect, text_processing.rs:551)."""
        word_count = len(tokens)
        unique_words = len({t.normalized for t in tokens})
        paragraph_count = (original if original is not None else text).count("\n\n") + 1
        avg_sentence_length = (word_count / len(sentences)) if sentences else 0.0
        syllables = sum(count_syllables(t.text) for t in tokens)
        avg_syllables = (syllables / word_count) if word_count else 0.0
        reading_level = 206.835 - 1.015 * avg_sentence_length - 84.6 * avg_syllables
        return TextStats(
            char_count=len(text),
            word_count=word_count,
            sentence_count=len(sentences),
            paragraph_count=paragraph_count,
            unique_words=unique_words,
            reading_level=reading_level,
            language="en",
        )

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def normalize_citation(citation: str) -> str:
        """Whitespace/comma cleanup (ref 584-590)."""
        return citation.strip().replace("  ", " ").replace(" ,", ",")

    @staticmethod
    def classify_citation(citation: str) -> CitationType:
        """Keyword classification (ref 593-607)."""
        lo = citation.lower()
        if "u.s.c." in lo:
            return CitationType.STATUTE
        if "c.f.r." in lo:
            return CitationType.REGULATION
        if "const" in lo:
            return CitationType.CONSTITUTIONAL
        return CitationType.CASE

    @staticmethod
    def classify_legal_term(term: str) -> LegalTermCategory:
        return _TERM_CATEGORY.get(term, LegalTermCategory.OTHER)

    def extract_key_phrases(
        self, tokens: Sequence[Token], max_phrases: int
    ) -> list[str]:
        """Stopword-delimited n-gram (2..5) phrases, longest-first
        (ref 653-681)."""
        phrases: list[str] = []
        current: list[str] = []
        for tok in tokens:
            if tok.is_stopword or tok.token_type == TokenType.PUNCTUATION:
                if len(current) >= 2:
                    phrases.append(" ".join(current))
                current = []
            else:
                current.append(tok.text)
                if len(current) >= 5:
                    phrases.append(" ".join(current))
                    current = []
        if len(current) >= 2:
            phrases.append(" ".join(current))
        phrases.sort(key=len, reverse=True)
        return phrases[:max_phrases]
