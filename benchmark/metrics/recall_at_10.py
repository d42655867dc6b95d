"""recall_at_10: over a seeded sample of the window's queries, the mean share of the reference's top results that the answer holds."""


def read(obs):
    return obs["recall"]
