"""The models: the paper's MLP and CNN and the LM zoo, built by name
(``registry.build_model``) with parameters in the reference's layout."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
