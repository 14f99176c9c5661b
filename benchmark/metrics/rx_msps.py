"""rx_msps: input samples of every block delivered to the sink, over the
window (first hand-off to the end of the runner's final drain), in
Msps.  Host clock."""


def read(run):
    return run.delivered * run.samples_per_block / run.window_s / 1e6
