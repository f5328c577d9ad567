"""Pages a second of the traced window: the pages it completed over its
seconds, closed when the page in flight was back (the end-to-end
``pages_per_s`` where a cell's runs spread too widely for its bound; read
under the profiler, so lower than an untraced window's)."""


def read(run):
    if not run.latencies or run.window_s <= 0:
        return None
    return len(run.latencies) / run.window_s
