"""Seconds of building the environment pool: reading the case (load_case),
the mesh statics, the padded environments (host clock).
"""

def read(run):
    return run["statics_s"]
