"""The host's time in the shard prover's stages as a share of the window, in
%: host entry to host exit of the stage spans ``prover_share.core`` reads,
from the program's span timeline.  Beside ``prover_share.core`` (the same
spans, settled on the device) it shows how much of each stage the host
spends before the device is done."""

STAGES = ("prove.upload", "prove.main_commit", "prove.perm_traces", "prove.perm_commit",
          "prove.quotient", "prove.quotient_commit", "prove.open")


def read(ctx):
    from zkmips_tpu_torch.utils import logger

    timeline = getattr(logger, "timeline", None)
    if timeline is None:
        return None
    ns = sum(r.host_end_ns - r.host_start_ns for r in timeline()
             if r.path.rsplit("/", 1)[-1] in STAGES)
    return 100.0 * ns / 1e9 / ctx.window_s if ns else None
