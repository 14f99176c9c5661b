"""rx_stages_host_ms: host ms a round inside the Costas receiver's five
stage spans (``qpsk_costas.carrier``, ``.mf``, ``.timing``, ``.interp``,
``.costas``), their union, from the traced segment: the receiver's own
enqueue, without the vmap wrapping and the stacking around it that
``dispatch_ms`` also counts."""

from benchlib.spans import union_ms


def read(run):
    return union_ms(run, "qpsk_costas.")
