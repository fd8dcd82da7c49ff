"""Module registry: ModuleSpec names → torch module factories (the subset of
`mmtpu/models/registry.py` this port has so far)."""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict

from mmtpu_torch.config.spec import ModuleSpec

logger = logging.getLogger(__name__)


# a frozen teacher the step runs beside the model (MMIN's): built by the
# runner, never a submodule, so it stays a spec
UNBUILT_KEYS = frozenset({"pretrained_model"})


def _build_nested(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Build nested ModuleSpecs (e.g. encoders inside fusion models),
    leaving `conv_block_args` specs (consumed as data) and the specs under
    `UNBUILT_KEYS` intact."""
    out = {}
    for k, v in kwargs.items():
        if k in UNBUILT_KEYS:
            out[k] = v
        elif isinstance(v, ModuleSpec) and v.name != "conv_block_args":
            out[k] = v.build()
        elif isinstance(v, dict):
            out[k] = _build_nested(v)
        else:
            out[k] = v
    return out


def _tolerant(cls) -> Callable[..., Any]:
    """Mirror reference constructors that absorb unknown kwargs via
    **kwargs: drop keys the constructor does not take, logging each drop so
    config typos stay visible."""
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}

    def factory(**kwargs):
        dropped = sorted(k for k in kwargs if k not in accepted)
        if dropped:
            logger.info(f"{cls.__name__}: ignoring extra config kwargs {dropped}")
        return cls(**{k: v for k, v in kwargs.items() if k in accepted})

    return factory


def _factories() -> Dict[str, Callable[..., Any]]:
    from mmtpu_torch.models import (
        autoencoder,
        avmnist,
        bert_text,
        cmam,
        conv,
        domain,
        fc,
        fusion,
        gcnet,
        kinetics_sounds,
        lenet,
        lstm,
        mmimdb,
        mmin,
        mult,
        redcore,
        resnet,
        self_mm,
        seq_extras,
        textcnn,
        transformer,
        utt_fusion,
        variational,
    )
    from mmtpu_torch.train import managers

    return {
        "resnet18": resnet.ResNet18,
        "resnet34": resnet.ResNet34,
        "resnet50": resnet.ResNet50,
        "resnetencoder": resnet.ResNetEncoder,
        "lenet5": lenet.LeNet5,
        "lenet5enhanced": lenet.LeNet5Enhanced,
        "lenetencoder": lenet.LeNetEncoder,
        "fcencoder": fc.FcEncoder,
        "fcclassifier": fc.FcClassifier,
        "simpleclassifier": fc.SimpleClassifier,
        "maxpoolfc": fc.MaxPoolFc,
        "lstmencoder": lstm.LSTMEncoder,
        "lstmencoder2": lstm.LSTMEncoder2,
        "textcnn": textcnn.TextCNN,
        "conv_block": conv.ConvBlock,
        "conv_block_args": conv.ConvBlockArgs,
        "mnist_audio": avmnist.MNISTAudio,
        "mnist_image": avmnist.MNISTImage,
        "avmnist": _tolerant(avmnist.AVMNIST),
        "monomodal_encoder": avmnist.MonomodalEncoder,
        # every spelling mmtpu's registry and CLIs accept
        "utt_fusion": utt_fusion.UttFusionModel,
        "utt-fusion": utt_fusion.UttFusionModel,
        "uttfusionmodel": utt_fusion.UttFusionModel,
        "cmam": cmam.CMAM,
        "dual_cmam": cmam.DualCMAM,
        "dualcmam": cmam.DualCMAM,
        "association_network": cmam.AssociationNetwork,
        "input_encoders": cmam.InputEncoders,
        "transformer": transformer.Transformer,
        "residual_ae": autoencoder.ResidualAE,
        "residual_xe": autoencoder.ResidualXE,
        "residual_unet_ae": autoencoder.ResidualUnetAE,
        "mmin": _tolerant(mmin.MMIN),
        "redcore": _tolerant(redcore.RedCore),
        "self_mm": self_mm.Self_MM,
        "self-mm": self_mm.Self_MM,
        "auvi_subnet": self_mm.AuViSubNet,
        "bert_text_encoder": bert_text.BertTextEncoder,
        "feature_manager": managers.FeatureManager,
        "center_manager": managers.CenterManager,
        "label_manager": managers.LabelManager,
        "maxout": fusion.MaxOut,
        "gated_bimodal": fusion.GatedBiModalNetwork,
        "multimodal_pooling": fusion.MultimodalPooling,
        "mmimdb": mmimdb.MMIMDb,
        "mmimdbmodalityencoder": mmimdb.MMIMDbModalityEncoder,
        "mmimdb_modality_encoder": mmimdb.MMIMDbModalityEncoder,
        "mlp_genre": mmimdb.MLPGenreClassifier,
        "mlp_genre_classifier": mmimdb.MLPGenreClassifier,
        "kineticssounds": _tolerant(kinetics_sounds.KineticsSounds),
        "kinetics_sounds_audio_encoder": kinetics_sounds.KineticsSoundsAudioEncoder,
        "kinetics_sounds_video_encoder": kinetics_sounds.KineticsSoundsVideoEncoder,
        "div_encoder": domain.DIVEncoder,
        "divencoder": domain.DIVEncoder,
        "seq_encoder": domain.SeqEncoder,
        "seqencoder": domain.SeqEncoder,
        "language_embedding": domain.LanguageEmbeddingLayer,
        "languageembeddinglayer": domain.LanguageEmbeddingLayer,
        "lstmencodervar": variational.VariationalLSTMEncoder,
        "lstm_encoder_var": variational.VariationalLSTMEncoder,
        "lstmencoder2var": variational.VariationalLSTMEncoder2,
        "textcnnvar": variational.VariationalTextCNN,
        "textcnn_var": variational.VariationalTextCNN,
        "linearvxe": variational.LinearVXE,
        "linear_vxe": variational.LinearVXE,
        # the registry-only MSA families (mmtpu's train_multimodal refuses them)
        "gcnet": gcnet.GraphModel,
        "graph_model": gcnet.GraphModel,
        "graph_network": gcnet.GraphNetwork,
        "matching_attention": gcnet.MatchingAttention,
        "mult": mult.MultModalTransformer,
        "gated_transformer": seq_extras.GatedTransformer,
    }


def build_module(name: str, **kwargs: Any) -> Any:
    reg = _factories()
    key = name.lower()
    if key not in reg:
        raise ValueError(
            f"Module {name!r} is not ported to mmtpu_torch yet. Available: {sorted(reg)}"
        )
    return reg[key](**_build_nested(kwargs))


def resolve_model_name(name: str) -> Callable[..., Any]:
    """String → model factory (mmtpu's `resolve_model_name`)."""
    key = name.lower()
    if key not in _factories():
        raise ValueError(f"Unknown model type: {name}")
    return lambda **kw: build_module(key, **kw)


def resolve_encoder(name: str) -> Callable[..., Any]:
    return resolve_model_name(name)
