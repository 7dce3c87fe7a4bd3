"""The shard prover's fenced device stages as a share of the window, in %:
upload, main commit, LogUp traces and commit, quotient and commit, open."""

STAGES = ("prove.upload", "prove.main_commit", "prove.perm_traces", "prove.perm_commit",
          "prove.quotient", "prove.quotient_commit", "prove.open")


def read(ctx):
    t = sum(ctx.span_total(s) for s in STAGES)
    return 100.0 * t / ctx.window_s if t else None
