"""VGG (counterpart: ``paddle_tpu/vision/models/vgg.py``; Simonyan and
Zisserman, 2015): configurations A, B, D and E (VGG-11/13/16/19), 3 x 3
convolutions with ReLU (and ``BatchNorm2D`` with ``batch_norm``), 2 x 2 max
pools, a 7 x 7 adaptive average pool and the 4096-wide classifier with
dropout. ``device`` places every parameter; ``pretrained=True`` raises:
nothing is downloaded."""
from ... import nn
from ...ops import plain as ops

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, device=None):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1,
                                    device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, device=device), nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, device=device), nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(ops.flatten(x, 1))
        return x


def _vgg(cfg, pretrained, batch_norm, device=None, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not available: nothing is "
                         "downloaded; load a state_dict instead")
    return VGG(make_layers(cfgs[cfg], batch_norm, device), device=device,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)
