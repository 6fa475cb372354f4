"""% of the traced window in which no operation ran on the card."""

from portbench.metrics import idle_share


def read(ctx):
    return idle_share(ctx)
