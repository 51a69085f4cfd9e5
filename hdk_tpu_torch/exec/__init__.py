"""Executor of the port.

The planner modules (optimizer, cost, ranges, codecache, prune) load from
hdk_tpu's exec directory through the path overlay described in
``hdk_tpu_torch/__init__.py``; every other module here is the port's own.
"""

from .. import _overlay

__path__ = _overlay(__file__, "exec")
