"""Host tables, dictionaries and importers.  ``table``'s columns cache
torch tensors on the session's device."""

from .table import Column, ColumnInfo, Table  # noqa: F401
from .schema import SchemaRegistry  # noqa: F401
from .dictionary import DictionaryRegistry, StringDictionary  # noqa: F401
