"""Host ms inside the journal's ``append`` (every entry: submissions,
transitions, rounds, decisions), per decided job."""


def read(rec):
    if rec["kind"] != "stream" or not rec["decisions"]:
        return None
    return 1e3 * rec["append_s"] / rec["decisions"]
