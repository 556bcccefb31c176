"""Sampled tokens a second: every token whose scheduler step ended inside
the window, over the window's seconds."""


def read(run):
    return run.tokens_in_window() / run.window_s
