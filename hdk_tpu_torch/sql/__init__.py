from .parser import parse  # noqa: F401
from .binder import Binder  # noqa: F401
from .lexer import SqlError  # noqa: F401
