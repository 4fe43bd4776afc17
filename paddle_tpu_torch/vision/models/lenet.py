"""LeNet (counterpart: ``paddle_tpu/vision/models/lenet.py``): two
conv-ReLU-maxpool stages on 1 x 28 x 28 images, then three Linear layers."""
from ... import nn
from ...ops import plain as ops


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, device=device),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, device=device),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, device=device),
                nn.Linear(120, 84, device=device),
                nn.Linear(84, num_classes, device=device),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(ops.flatten(x, 1))
        return x
