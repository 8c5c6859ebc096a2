"""Centres uniform over the square ``range`` x ``range``."""


def draw(rng, n, c):
    return rng.uniform(*c["range"], size=(n, 2))
