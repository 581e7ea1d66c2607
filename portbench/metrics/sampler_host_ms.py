"""``sampler_host_ms``: host ms a leapfrog spends in the sampler, outside
the program's value+grad and outside the waits for the card, from spans
around the calls in a slice without the profiler: each call's outputs are
waited for right after it, that wait timed apart, and the slice's time less
the calls' and the waits' is the sampler's."""


def read(run):
    span = getattr(run, "span", None)
    if run.device.type != "cuda" or not span or not span[1]:
        return None
    seconds, calls, inside, waits = span
    return (seconds - inside - waits) * 1e3 / calls
