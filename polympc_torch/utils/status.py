"""Solver status codes as integer constants (per-lane status vectors).

Replaces the reference's status enums (qp_base.hpp:55-62, sqp_base.hpp:49-55):
in a batch each instance carries its own int32 status.
"""

UNINITIALIZED = 0
SOLVED = 1
MAX_ITER_EXCEEDED = 2
UNSOLVED = 3
INFEASIBLE = 4
INCONSISTENT = 5
INVALID_SETTINGS = 6

_NAMES = {
    0: "UNINITIALIZED",
    1: "SOLVED",
    2: "MAX_ITER_EXCEEDED",
    3: "UNSOLVED",
    4: "INFEASIBLE",
    5: "INCONSISTENT",
    6: "INVALID_SETTINGS",
}


def status_name(code: int) -> str:
    return _NAMES.get(int(code), f"UNKNOWN({code})")
