"""Context-window errors of the providers (the part of
``repro/core/batching.py`` that the provider needs)."""


class ContextOverflowError(Exception):
    """Raised by providers when a request exceeds the context budget."""
