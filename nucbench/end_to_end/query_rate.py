"""``query_rate`` (queries/s): queries answered over the window's time."""


def read(summary: dict):
    if not summary.get("window_s") or "queries" not in summary:
        return None
    return summary["queries"] / summary["window_s"]
