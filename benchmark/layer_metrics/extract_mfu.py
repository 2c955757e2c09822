"""extract_mfu: the frames extracted in the traced window times the
operations of one ResNet-152 forward, over the window's length times the
bfloat16 peak, in %.

The operations are counted from the convolutions' shapes, 2 Cout Cin kh
kw Hout Wout each, the 7x7/2 stem included (at 224 x 224: 23.023 GFLOP a
frame)."""

import peaks


def resnet_flops(blocks, hw: int = 224) -> int:
    def conv(cin, cout, k, out_hw):
        return 2 * cout * cin * k * k * out_hw * out_hw

    hw //= 2
    total = conv(3, 64, 7, hw)
    hw //= 2                      # the 3x3/2 max pool
    cin, width = 64, 64
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            out_hw = hw // 2 if (stage > 0 and b == 0) else hw
            total += (conv(cin, width, 1, hw) + conv(width, width, 3, out_hw)
                      + conv(width, 4 * width, 1, out_hw))
            if b == 0:
                total += conv(cin, 4 * width, 1, out_hw)
            cin, hw = 4 * width, out_hw
        width *= 2
    return total


def read(obs):
    window = obs["window"]
    if not window.ops or not obs["frames"]:
        return None
    ext = obs["config"]["extractor"]
    ops = obs["frames"] * resnet_flops(ext["blocks"], ext["image_size"])
    return 100.0 * ops / (window.seconds * peaks.BF16_FLOPS)
