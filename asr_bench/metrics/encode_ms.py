"""Mean over the traced window's batches of the span from the batch's
start to the end of the encoder pass (enhancer, frontend, VGG/BLSTMP, CTC
and attention projections), synchronised there."""


def read(run):
    xs = run.get("encode_ms")
    if run["kind"] != "decode" or not xs:
        return None
    return sum(xs) / len(xs)
