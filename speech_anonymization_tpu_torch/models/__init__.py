from .autoencoders import ConvAutoencoder, DummyFullyConnectedAutoencoder, FullyConnectedAutoencoder
from .classifiers import (
    DummyFullyConnSexClassifier,
    FullyConnSexClassifier,
    SexClassifier1D,
    TDNNSexClassifier,
)
from .cyclegan import CycleGANGenerator, DownSampleGenerator, ResidualLayer
from .endtoend import ConvReconstruction
from .xvector import Xvector, XvectorClassifier
from .asr import ASRHeads, ASRModel
from .transformer import TransformerLM
