"""Type system for rayforce-tpu.

Type codes, null/infinity sentinels, and numpy dtype mappings. The codes and
sentinel bit patterns intentionally match the reference engine (see
reference core/rayforce.h:50-108) so that on-disk files, the IPC wire format,
and printed output are interchangeable between the two engines. The
representation here is brand new: columns are numpy arrays on the host
control plane and JAX device arrays on the device compute path.
"""
from __future__ import annotations

import numpy as np

# Simple types. Positive code = vector of that type, negative = atom.
LIST = 0
B8 = 1
U8 = 2
I16 = 3
I32 = 4
I64 = 5
SYMBOL = 6
DATE = 7
TIME = 8
TIMESTAMP = 9
F64 = 10
GUID = 11
C8 = 12
ENUM = 20

# Lazy map types (materialized on demand).
MAPFILTER = 71
MAPGROUP = 72
MAPFD = 73
MAPCOMMON = 74
MAPLIST = 75

# Parted types: a column stored as a list of per-partition vectors.
PARTEDLIST = 77
PARTED_OF = {  # simple type -> parted type
    B8: PARTEDLIST + B8,
    U8: PARTEDLIST + U8,
    I16: PARTEDLIST + I16,
    I32: PARTEDLIST + I32,
    I64: PARTEDLIST + I64,
    DATE: PARTEDLIST + DATE,
    TIME: PARTEDLIST + TIME,
    TIMESTAMP: PARTEDLIST + TIMESTAMP,
    F64: PARTEDLIST + F64,
    GUID: PARTEDLIST + GUID,
    ENUM: PARTEDLIST + ENUM,
}
UNPARTED_OF = {v: k for k, v in PARTED_OF.items()}

TABLE = 98
DICT = 99
LAMBDA = 100
UNARY = 101
BINARY = 102
VARY = 103
TOKEN = 125
NULL = 126
ERR = 127

# Null sentinels (bit-identical to the reference, rayforce.h:97-108).
NULL_I16 = np.int16(-0x8000)
NULL_I32 = np.int32(-0x80000000)
NULL_I64 = np.int64(-0x8000000000000000)
NULL_F64 = np.float64("nan")
INF_I16 = np.int16(0x7FFF)
INF_I32 = np.int32(0x7FFFFFFF)
INF_I64 = np.int64(0x7FFFFFFFFFFFFFFF)
INF_F64 = np.float64("inf")

NULL_BY_TYPE = {
    I16: NULL_I16,
    I32: NULL_I32,
    I64: NULL_I64,
    F64: NULL_F64,
    SYMBOL: NULL_I64,
    DATE: NULL_I32,
    TIME: NULL_I32,
    TIMESTAMP: NULL_I64,
}
INF_BY_TYPE = {
    I16: INF_I16,
    I32: INF_I32,
    I64: INF_I64,
    F64: INF_F64,
    DATE: INF_I32,
    TIME: INF_I32,
    TIMESTAMP: INF_I64,
}

# numpy dtype for each simple vector type.
DTYPE = {
    B8: np.int8,
    U8: np.uint8,
    I16: np.int16,
    I32: np.int32,
    I64: np.int64,
    SYMBOL: np.int64,     # interned symbol ids
    DATE: np.int32,       # days since 1970.01.01
    TIME: np.int32,       # milliseconds since midnight
    TIMESTAMP: np.int64,  # nanoseconds since 1970.01.01T00:00
    F64: np.float64,
    C8: np.uint8,         # raw bytes
    ENUM: np.int64,       # indices into a symbol domain
}

# Width in bytes of one element, for serde (reference serde.c:31-59).
ELEM_SIZE = {
    B8: 1, U8: 1, I16: 2, I32: 4, I64: 8, SYMBOL: 8, DATE: 4,
    TIME: 4, TIMESTAMP: 8, F64: 8, GUID: 16, C8: 1, ENUM: 8,
}

TYPE_NAMES = {
    B8: "b8", U8: "u8", I16: "i16", I32: "i32", I64: "i64",
    SYMBOL: "symbol", DATE: "date", TIME: "time", TIMESTAMP: "timestamp",
    F64: "f64", GUID: "guid", C8: "c8", ENUM: "enum", LIST: "list",
    TABLE: "table", DICT: "dict", LAMBDA: "lambda", UNARY: "unary",
    BINARY: "binary", VARY: "vary", NULL: "null", ERR: "ERROR",
}

# Numeric promotion ladder for arithmetic: i16 < i32 < i64 < f64.
NUMERIC_RANK = {B8: 0, U8: 0, I16: 1, I32: 2, I64: 3, F64: 4}
TEMPORAL = (DATE, TIME, TIMESTAMP)


def is_atom(t: int) -> bool:
    return t < 0


def is_vector(t: int) -> bool:
    return 0 < t <= ENUM or t in UNPARTED_OF


def is_parted(t: int) -> bool:
    return t in UNPARTED_OF


def is_integer(t: int) -> bool:
    return t in (B8, U8, I16, I32, I64)


def is_numeric(t: int) -> bool:
    return t in NUMERIC_RANK


def is_temporal(t: int) -> bool:
    return t in TEMPORAL
