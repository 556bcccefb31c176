"""Sampled tokens a joule: the window's tokens over the card's energy in the
window (nvidia-smi's power draw, sampled beside it and integrated)."""


def read(run):
    if not run.energy_j:
        return None
    return run.tokens_in_window() / run.energy_j
