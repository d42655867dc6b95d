"""setup_s: seconds from the process's start to the first timed request, less the reference's own (its tokens and embeddings)."""


def read(obs):
    return obs["setup_s"]
