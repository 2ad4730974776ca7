"""``host_issue_ms.serve``: the host's milliseconds inside one call of the
serving entry (``ServingEngine.__call__``), which returns before the card
has finished, as the mean over the window's batches on the harness's clock.
Where it nears the card's time a batch, the host sets the pace."""

import statistics


def read(run):
    issue = run.window.get("issue")
    return 1e3 * statistics.fmean(issue) if issue else None
