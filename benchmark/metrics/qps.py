"""qps: queries answered in the window over the window's seconds (the window runs to the end of its last batch)."""


def read(obs):
    return obs["answered"] / obs["window_s"]
