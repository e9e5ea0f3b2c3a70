"""``nt_rate`` (Gnt/s): the read set's real nucleotides (padding left out)
that the window completed, over the window's time, which ends in a
synchronize."""


def read(summary: dict):
    if not summary.get("window_s") or "nt" not in summary:
        return None
    return summary["nt"] / summary["window_s"] / 1e9
