from .logging import NULL_LOG, EventLog

__all__ = ["NULL_LOG", "EventLog"]
