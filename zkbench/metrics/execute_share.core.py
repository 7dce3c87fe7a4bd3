"""The executor's share of the window, in %: the ``client.execute`` spans
(``ProverClient.prove`` running ``execute_for_proving``) over the window."""


def read(ctx):
    t = ctx.span_total("client.execute")
    return 100.0 * t / ctx.window_s if t else None
