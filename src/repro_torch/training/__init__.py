"""The paper's performance indices (``metrics``); the language-model
training stack waits for its own slice."""
from repro_torch.training import metrics  # noqa: F401
