"""idle_share: 100 x (1 - the union of device operations' intervals over the traced stretch)."""
from benchmark.readers import idle_share as read  # noqa: F401
