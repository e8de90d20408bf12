"""Label-smoothing softmax cross-entropy (reference: ``apex/contrib/xentropy``)."""
from .softmax_xentropy import (SoftmaxCrossEntropyLoss,  # noqa: F401
                               softmax_xentropy_loss)
