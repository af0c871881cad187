"""The whole eval's share of the cards' bf16 peak, in percent: the model
FLOPs of the window's episodes (counted from the configuration's shapes,
``yardstick.episode_flops``) over the window's seconds times 989 TFLOP/s
times the cards."""


def read(ctx):
    flops = ctx["flops_per_episode"] * ctx["window_episodes"]
    return 100.0 * flops / (ctx["window_seconds"] * ctx["yardstick"].PEAK_BF16_FLOPS * ctx["cards"])
