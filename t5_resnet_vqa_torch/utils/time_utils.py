"""Time formatting helper.

Parity with the reference's convert_time_to_readable_format
(dataset_utils/utils.py:18-33): seconds -> "Hh Mm Ss" style
string used by the 10%-interval step logs.
"""

from __future__ import annotations


def convert_time_to_readable_format(total_seconds: float) -> str:
    total_seconds = float(total_seconds)
    hours = int(total_seconds // 3600)
    minutes = int((total_seconds % 3600) // 60)
    seconds = total_seconds % 60
    if hours > 0:
        return f"{hours}h {minutes}m {seconds:.2f}s"
    if minutes > 0:
        return f"{minutes}m {seconds:.2f}s"
    return f"{seconds:.3f}s"
