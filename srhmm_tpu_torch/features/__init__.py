from .frontend import global_cmvn_stats

__all__ = ["global_cmvn_stats"]
