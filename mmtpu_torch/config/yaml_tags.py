"""YAML tag registry for the port's config loader (counterpart of
`mmtpu/config/yaml_tags.py`).

mmtpu registers its tags on the global `yaml.SafeLoader`; the port
registers them on its own `SafeLoader` subclass, so a process that loads
configs with both packages gets each package's constructors. PyYAML is
imported only inside `load_yaml`: nothing else in the port needs it.

Config tags (`!DatasetConfig`, `!ModelConfig`, ...) resolve to plain
mappings that `StandardMultimodalConfig.from_parsed` assembles — the same
path a plain-dict config takes. Model tags resolve to ModuleSpecs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from mmtpu_torch.config.spec import ModuleSpec
from mmtpu_torch.modalities import add_modality

# Model tags of the modules the port has; a config naming another model
# fails to parse until that model is ported.
MODEL_TAGS: Dict[str, str] = {
    "!MNISTAudio": "mnist_audio",
    "!MNISTImage": "mnist_image",
    "!ConvBlock": "conv_block",
    "!ConvBlockArgs": "conv_block_args",
    "!ResNet18": "resnet18",
    "!ResNet34": "resnet34",
    "!ResNet50": "resnet50",
    "!ResNetEncoder": "resnetencoder",
    "!LeNet5": "lenet5",
    "!LeNet5Enhanced": "lenet5enhanced",
    "!LeNetEncoder": "lenetencoder",
    "!FcEncoder": "fcencoder",
    "!FcClassifier": "fcclassifier",
    "!LSTMEncoder": "lstmencoder",
    "!LSTMEncoder2": "lstmencoder2",
    "!TextCNN": "textcnn",
    "!Transformer": "transformer",
    "!ResidualAE": "residual_ae",
    "!ResidualXE": "residual_xe",
    "!UttFusionModel": "utt_fusion",
    "!AssociationNetwork": "association_network",
    "!InputEncoders": "input_encoders",
    "!Self_MM": "self_mm",
    "!AuViSubNet": "auvi_subnet",
    "!BertTextEncoder": "bert_text_encoder",
    "!FeatureManager": "feature_manager",
    "!CenterManager": "center_manager",
    "!LabelManager": "label_manager",
    "!MMIMDb": "mmimdb",
    "!MMIMDbModalityEncoder": "mmimdb_modality_encoder",
    "!MLPGenreClassifier": "mlp_genre_classifier",
    "!MaxOut": "maxout",
    "!GatedBiModalNetwork": "gated_bimodal",
    "!MultimodalPooling": "multimodal_pooling",
    "!KineticsSoundsAudioEncoder": "kinetics_sounds_audio_encoder",
    "!KineticsSoundsVideoEncoder": "kinetics_sounds_video_encoder",
}

# Config tags of mmtpu's standard configs; each resolves to a plain mapping.
CONFIG_TAGS = (
    "!StandardConfig",
    "!CMAMConfig",
    "!ExperimentConfig",
    "!ModelConfig",
    "!DataConfig",
    "!DatasetConfig",
    "!MissingPatternConfig",
    "!ModalityConfig",
    "!Optimizer",
    "!LossFunctionGroup",
)

_LOADER = None


def _loader_class():
    """The port's SafeLoader subclass, built on first use."""
    global _LOADER
    if _LOADER is not None:
        return _LOADER
    import yaml

    class PortLoader(yaml.SafeLoader):
        pass

    def mapping(loader, node) -> Dict[str, Any]:
        return loader.construct_mapping(node, deep=True)

    def modality(loader, node):
        return add_modality(loader.construct_scalar(node))

    def spec(name: str):
        def construct(loader, node):
            return ModuleSpec(name, loader.construct_mapping(node, deep=True))

        return construct

    PortLoader.add_constructor("!Modality", modality)
    for tag in CONFIG_TAGS:
        PortLoader.add_constructor(tag, mapping)
    for tag, name in MODEL_TAGS.items():
        PortLoader.add_constructor(tag, spec(name))
    _LOADER = PortLoader
    return _LOADER


def load_yaml(path: str | Path) -> Dict[str, Any]:
    """Parse a config file into plain mappings, Modalities and ModuleSpecs."""
    import yaml

    with open(path) as f:
        return yaml.load(f, Loader=_loader_class())  # noqa: S506 — SafeLoader subclass
