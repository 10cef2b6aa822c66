"""The model's share of a request: the benchmark's host-clock span around the
pipeline call and the copy of its pulses to the host, summed over the
untraced window's requests and divided by their number."""


def read(ctx):
    total, count = ctx["spans"].get("model", (0.0, 0))
    if ctx["unit"] != "request" or not count:
        return None
    return 1e3 * total / count
