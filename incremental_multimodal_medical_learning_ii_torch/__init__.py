"""PyTorch / CUDA port of the incremental multimodal medical learning stack.

The counterpart, module by module, of ``incremental_multimodal_medical_learning_ii_tpu``
(the JAX package, which stays the reference).  This package imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its
own copies of the host code it needs.  Every Pallas kernel of the JAX
package on a ported path is a hand-written Hopper kernel here
(``csrc/``), built at first use and bound with ``ctypes``
(``ops/cuda_build.py``); beside each kernel sits its plain PyTorch version.

Ported so far: the serving path — raw CXR -> preprocess -> BioViL
ResNet-50 -> adapters -> prompt-cosine scores (``inference.py``,
``cli/classify.py``, ``cli/serve.py``) — and the CXR-BERT text tower
(``models/cxr_bert.py`` with the flash-attention kernel,
``text/tokenizer.py``, ``text/engine.py``, ``models/convert.py`` for the
reference's weight files), and the paper's experiment over cached
embeddings: the train step, optimisers and myCL/profCL
(``engine/steps.py``, ``engine/cl.py``), metrics without scikit-learn
(``evaluation/metrics.py``), an event writer without tensorboard
(``evaluation/tb.py``), the trainer, protocols, checkpoints and the three
drivers (``cli/zero_joint_bounds.py``, ``cli/data_incremental.py``,
``cli/class_incremental.py``).  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from incremental_multimodal_medical_learning_ii_torch.utils.config import (  # noqa: F401
    AdapterKind,
    CHEXPERT_COMPETITION_TASKS,
    ExperimentConfig,
    JOINT_FEATURE_SIZE,
    PromptMode,
    joint_config,
)


def __getattr__(name):  # lazy heavyweight imports
    if name == "ChexpertClassifier":
        from incremental_multimodal_medical_learning_ii_torch.inference import (
            ChexpertClassifier,
        )

        return ChexpertClassifier
    if name == "PromptBank":
        from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank

        return PromptBank
    if name == "params_from_jax":
        from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax

        return params_from_jax
    raise AttributeError(name)
