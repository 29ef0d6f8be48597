"""Re-ID matching: best cosine score per gallery row over the query rows."""

from .ops import reid_match

__all__ = ["reid_match"]
