"""``serve_host_issue_ms``: the host's time in ``test_async``, from the call
to its return with no sync, the mean over the measured (untraced) window's
images."""


def read(run):
    issue = run.record.get("issue_s")
    return 1e3 * sum(issue) / len(issue) if issue else None
