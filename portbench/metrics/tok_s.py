"""`tok_s`: all the window's work (prompt tokens of every request admitted
in it, plus every token served) over all its host-clock time."""


def read(rec):
    return rec["tok_s"]
