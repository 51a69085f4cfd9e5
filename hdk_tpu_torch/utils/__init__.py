from .timer import DebugTimer, enable_debug_timer, timer_report  # noqa: F401
