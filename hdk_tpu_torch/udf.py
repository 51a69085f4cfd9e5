"""User-defined scalar functions with torch bodies.

Reference: omniscidb/QueryEngine/UdfCompiler.h:30 — the reference
compiles C++ UDF sources to LLVM IR and links them into generated
kernels.  Here a UDF is a Python function over torch tensors that the
scalar evaluator calls where the expression stands, on the session's
device, like any builtin.

Contract for registered functions:
  * called with one torch tensor per argument (the column data, never the
    validity mask), on the session's device, each of the same length (a
    constant argument may come as a 0-d tensor);
  * returns a tensor of that length, which is cast to the declared
    return type;
  * runs eagerly: reading a value on the host (``.item()``, a Python
    ``if`` on a tensor) synchronizes the device, which is allowed and
    costs the caller;
  * NULL handling is SQL-style by default: an output row is NULL when
    any input row is NULL (``null_propagation=True``).  With
    ``null_propagation=False`` the function receives a trailing
    ``valid`` bool tensor (or None) and must return ``(data, mask)``.

Registering a name again replaces its body; steps that call it are then
built anew.

Example::

    hdk.register_udf("gcd", lambda a, b: torch.gcd(a, b),
                     arg_types=[t.int64(), t.int64()], ret_type=t.int64())
    hdk.sql("SELECT gcd(a, b) FROM t")
    ht.proj(g=hdk.call("gcd", ht["a"], ht["b"]))
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from . import types as t


@dataclass
class Udf:
    name: str
    fn: Callable
    arg_types: List[t.Type]
    ret_type: t.Type
    null_propagation: bool = True


class UdfRegistry:
    """Session-scoped registry (reference: table of ExtensionFunction
    signatures).  ``generation`` feeds the step cache keys of plans that
    call a UDF, so re-registering a name builds their steps anew."""

    def __init__(self) -> None:
        self._udfs: Dict[str, Udf] = {}
        self.generation = 0

    def register(self, name: str, fn: Callable,
                 arg_types: Sequence[t.Type], ret_type: t.Type,
                 null_propagation: bool = True) -> Udf:
        name = name.lower()
        udf = Udf(name, fn, list(arg_types), ret_type, null_propagation)
        self._udfs[name] = udf
        self.generation += 1
        return udf

    def unregister(self, name: str) -> None:
        if self._udfs.pop(name.lower(), None) is not None:
            self.generation += 1

    def get(self, name: str) -> Optional[Udf]:
        return self._udfs.get(name.lower())

    def names(self) -> List[str]:
        return sorted(self._udfs)

    def __bool__(self) -> bool:
        return bool(self._udfs)
