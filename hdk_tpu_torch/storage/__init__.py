"""Host tables, dictionaries and importers.

``table`` is the port's own module (its columns cache torch tensors on the
session's device); the rest load from hdk_tpu's storage directory through
the path overlay described in ``hdk_tpu_torch/__init__.py``.
"""

from .. import _overlay

__path__ = _overlay(__file__, "storage")

from .table import Column, ColumnInfo, Table  # noqa: E402,F401
from .schema import SchemaRegistry  # noqa: E402,F401
from .dictionary import DictionaryRegistry, StringDictionary  # noqa: E402,F401
