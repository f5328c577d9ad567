"""Milliseconds a page outside the pipeline's stages: the page's wall time
(the call to ``translate`` until the rendered image is in host memory)
less its stage spans; orchestration, image load and conversion, hooks."""


def read(run):
    if not run.latencies:
        return None
    outside = [lat - sum(st.values())
               for lat, st in zip(run.latencies, run.stages)]
    return 1000 * sum(outside) / len(outside)
