"""MobileNet V1 and V2 (counterpart: ``paddle_tpu/vision/models/
mobilenet.py``; Howard et al., 2017; Sandler et al., 2018): convolutions
without bias, each followed by ``BatchNorm2D`` and ReLU (V1) or ReLU6 (V2),
depthwise 3 x 3 convolutions as ``groups`` = channels, V2's inverted
residual blocks; widths scaled by ``scale``. ``device`` places every
parameter; ``pretrained=True`` raises: nothing is downloaded."""
from ... import nn
from ...ops import plain as ops


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, act="relu", device=None):
        super().__init__()
        self.conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, groups=groups,
                              bias_attr=False, device=device)
        self.bn = nn.BatchNorm2D(out_channels, device=device)
        self.act = nn.ReLU6() if act == "relu6" else (
            nn.ReLU() if act == "relu" else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, device=None):
        super().__init__()
        self.dw = ConvBNLayer(in_channels, int(out_channels1 * scale), 3,
                              stride=stride, padding=1,
                              groups=int(num_groups * scale), device=device)
        self.pw = ConvBNLayer(int(out_channels1 * scale),
                              int(out_channels2 * scale), 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1,
                                 device=device)
        cfg = [
            (s(32), 32, 64, 32, 1),
            (s(64), 64, 128, 64, 2),
            (s(128), 128, 128, 128, 1),
            (s(128), 128, 256, 128, 2),
            (s(256), 256, 256, 256, 1),
            (s(256), 256, 512, 256, 2),
            (s(512), 512, 512, 512, 1),
            (s(512), 512, 512, 512, 1),
            (s(512), 512, 512, 512, 1),
            (s(512), 512, 512, 512, 1),
            (s(512), 512, 512, 512, 1),
            (s(512), 512, 1024, 512, 2),
            (s(1024), 1024, 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(inc, c1, c2, g, st, scale, device=device)
            for inc, c1, c2, g, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, device=device)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(ops.flatten(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6",
                                      device=device))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6", device=device),
            ConvBNLayer(hidden, oup, 1, act=None, device=device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = int(32 * scale)
        self.conv1 = ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                 act="relu6", device=device)
        blocks = []
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    device=device))
                input_channel = out_c
        self.blocks = nn.Sequential(*blocks)
        self.last_channel = int(1280 * max(1.0, scale))
        self.conv_last = ConvBNLayer(input_channel, self.last_channel, 1,
                                     act="relu6", device=device)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2),
                nn.Linear(self.last_channel, num_classes, device=device))

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(ops.flatten(x, 1))
        return x


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained weights are not available: nothing is "
                         "downloaded; load a state_dict instead")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
