"""Mean recall@10 of the checked answers against the reference's exact
top 10; absent where the traffic asks for another k."""


def read(run: dict):
    k, recall = run["recall"]
    return recall if k == 10 else None
