"""``host_issue_ms.train``: the host's milliseconds inside one call of the
training step (``make_train_step``'s ``train_step``, which keeps its
metrics on the card and returns before the card has finished), as the mean
over the window's steps on the harness's clock."""

import statistics


def read(run):
    issue = run.window.get("issue")
    return 1e3 * statistics.fmean(issue) if issue else None
