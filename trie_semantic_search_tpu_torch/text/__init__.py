"""Host-side text processing (feeds the trie build and the tokenizer)."""

from .processor import (
    Citation,
    CitationType,
    EntityType,
    LegalTerm,
    LegalTermCategory,
    NamedEntity,
    ProcessedText,
    TextProcessor,
    TextStats,
    Token,
    TokenType,
    count_syllables,
)

__all__ = [
    "Citation",
    "CitationType",
    "EntityType",
    "LegalTerm",
    "LegalTermCategory",
    "NamedEntity",
    "ProcessedText",
    "TextProcessor",
    "TextStats",
    "Token",
    "TokenType",
    "count_syllables",
]
