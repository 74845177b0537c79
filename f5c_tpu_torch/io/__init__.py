from .fast5 import Fast5File, read_fast5_signal, Signal

__all__ = ["Fast5File", "read_fast5_signal", "Signal"]
