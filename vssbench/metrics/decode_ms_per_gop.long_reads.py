"""Mean host time of one repro_torch.codec.decode_gop call in the window,
ms."""
from vssbench import readers


def read(run):
    return readers.gop_ms(run, "decode_gop")
