"""The card's peak allocated memory over the window, in GB of 1e9 bytes
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start); None off the card."""


def read(record):
    peak = record["peak_bytes"]
    return None if peak is None else peak / 1e9
