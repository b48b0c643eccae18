"""Order statistics shared by the readers."""
import math
from typing import List, Optional


def p95(values: List[float]) -> Optional[float]:
    """Nearest-rank 95th percentile; None for no values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
