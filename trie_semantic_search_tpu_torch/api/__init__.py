"""HTTP serving layer: the aiohttp API and the request micro-batcher."""

from .batching import BatchingQueue
from .server import ApiServer

__all__ = ["ApiServer", "BatchingQueue"]
