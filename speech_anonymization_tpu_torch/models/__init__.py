from .autoencoders import ConvAutoencoder
from .classifiers import TDNNSexClassifier
from .xvector import Xvector, XvectorClassifier
from .asr import ASRHeads, ASRModel
from .transformer import TransformerLM
