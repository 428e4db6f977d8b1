"""Mean over the traced window's batches of the span from the end of the
encoder pass to the tokens on the host: the beam search."""


def read(run):
    xs = run.get("search_ms")
    if run["kind"] != "decode" or not xs:
        return None
    return sum(xs) / len(xs)
