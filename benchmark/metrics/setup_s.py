"""setup_s (s, end to end, host clock): from the start of the process to the
end of the warm-up: imports, the card's context, the kernels' library,
the inputs made from the seed, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
