"""Model families of the port."""

from .bert import (Bert, BertConfig, EncoderBlock, bert_base, bert_large,
                   bert_tiny, mlm_loss)
from .llama import Llama, LlamaConfig, llama3_8b, llama_tiny
from .mixtral import (Mixtral, MixtralBlock, MixtralConfig, MoEMLP,
                      mixtral_8x7b, mixtral_tiny)
from .resnet import (BottleneckResNetBlock, ResNet, ResNet18, ResNet34,
                     ResNet50, ResNet101, ResNet152, ResNetBlock, ResNetTiny)
