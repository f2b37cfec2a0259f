from .helpers import (
    compression_ratio,
    exact_div,
    format_timestamp,
    get_end,
    get_start,
    make_safe,
    optional_float,
    optional_int,
    str2bool,
)
from .writers import get_writer

__all__ = [
    "compression_ratio",
    "exact_div",
    "format_timestamp",
    "get_end",
    "get_start",
    "get_writer",
    "make_safe",
    "optional_float",
    "optional_int",
    "str2bool",
]
