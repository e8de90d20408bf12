"""Op-classification lists for the O1 / O4 casts.

Counterpart of ``apex_tpu/amp/lists/jnp_overrides.py``.  The same five
categories, each a dict from the JAX package's name (``"jnp.matmul"``,
``"lax.dot_general"``, ``"nn.softmax"``, ``"linalg.norm"``) to the torch
callables that compute that function.  Where torch spells one function in
several namespaces (``torch.softmax`` / ``F.softmax`` /
``torch.special.softmax``, ``torch.div`` / ``torch.divide``), every
spelling is listed: the cast mode looks a call up by the identity of the
callable it receives, so a spelling left out would run uncast.

Categories:
  - LOW_PREC: products whose FLOPs land on the tensor cores, inputs cast to
    the low-precision type (fp16 at O1, bf16 at O4);
  - FP32: numerically sensitive functions, inputs cast to fp32;
  - CASTS: binary functions, inputs promoted to the widest floating type;
  - SEQUENCE_CASTS: list-taking functions, the list promoted to its
    widest floating type;
  - BANNED: functions that raise under the casts (none by default; the
    mechanism is kept for user registration).

Tensor methods and operators (``x @ w``, ``x.sum()``, ``a + b``) are not
listed: a JAX ``Array``'s methods are bound to internal functions, not to
the ``jnp`` attributes the JAX package patches, so it never casts them.
"""
import torch
import torch.nn.functional as F

__all__ = ["LOW_PREC", "FP32", "CASTS", "SEQUENCE_CASTS", "BANNED_FUNCS",
           "FP64_RESULT"]

_CONVS = (F.conv1d, F.conv2d, F.conv3d)
_CONV_TRANSPOSES = (F.conv_transpose1d, F.conv_transpose2d,
                    F.conv_transpose3d)

# JNP_LOW_PREC, LAX_LOW_PREC (NN_LOW_PREC is empty); the bf16 lists equal
# the fp16 ones in the JAX package
LOW_PREC = {
    "jnp.dot": (torch.dot,),
    "jnp.matmul": (torch.matmul,),
    "jnp.vdot": (torch.vdot,),
    "jnp.inner": (torch.inner,),
    "jnp.outer": (torch.outer,),
    "jnp.tensordot": (torch.tensordot,),
    "jnp.einsum": (torch.einsum,),
    "lax.dot": (torch.mm,),
    "lax.dot_general": (torch.mm, torch.bmm, F.linear),
    "lax.conv": _CONVS,
    "lax.conv_general_dilated": _CONVS,
    "lax.conv_transpose": _CONV_TRANSPOSES,
}

# JNP_FP32, LAX_FP32, NN_FP32, LINALG_FP32
FP32 = {
    "jnp.exp": (torch.exp,),
    "jnp.expm1": (torch.expm1, torch.special.expm1),
    "jnp.log": (torch.log,),
    "jnp.log10": (torch.log10,),
    "jnp.log1p": (torch.log1p, torch.special.log1p),
    "jnp.log2": (torch.log2,),
    "jnp.power": (torch.pow,),
    "jnp.float_power": (torch.float_power,),
    "jnp.cosh": (torch.cosh,),
    "jnp.sinh": (torch.sinh,),
    "jnp.tan": (torch.tan,),
    "jnp.arccos": (torch.acos, torch.arccos),
    "jnp.arcsin": (torch.asin, torch.arcsin),
    "jnp.arctan": (torch.atan, torch.arctan),
    "jnp.cumprod": (torch.cumprod,),
    "jnp.cumsum": (torch.cumsum,),
    "jnp.prod": (torch.prod,),
    "jnp.sum": (torch.sum,),
    "jnp.mean": (torch.mean,),
    "jnp.var": (torch.var,),
    "jnp.std": (torch.std,),
    "lax.exp": (torch.exp,),
    "lax.log": (torch.log,),
    "lax.log1p": (torch.log1p, torch.special.log1p),
    "lax.pow": (torch.pow,),
    "lax.rsqrt": (torch.rsqrt,),
    "lax.logistic": (torch.sigmoid, torch.special.expit),
    "lax.erf": (torch.erf, torch.special.erf),
    "lax.erfc": (torch.erfc, torch.special.erfc),
    "lax.erf_inv": (torch.erfinv, torch.special.erfinv),
    "nn.softmax": (torch.softmax, F.softmax, torch.special.softmax),
    "nn.log_softmax": (torch.log_softmax, F.log_softmax,
                       torch.special.log_softmax),
    "nn.softplus": (F.softplus,),
    "nn.logsumexp": (torch.logsumexp, torch.special.logsumexp),
    "linalg.norm": (torch.linalg.norm, torch.norm),
}

# torch.float_power computes in float64 whatever its inputs; the JAX
# package's, without 64-bit mode, gives fp32.  Under the fp32 list its
# result is cast to fp32, the dtype the JAX package gives.
FP64_RESULT = (torch.float_power,)

# JNP_CASTS
CASTS = {
    "jnp.add": (torch.add,),
    "jnp.subtract": (torch.sub, torch.subtract),
    "jnp.multiply": (torch.mul, torch.multiply),
    "jnp.divide": (torch.div, torch.divide),
    "jnp.true_divide": (torch.true_divide,),
    "jnp.equal": (torch.eq,),
    "jnp.greater": (torch.gt, torch.greater),
    "jnp.greater_equal": (torch.ge, torch.greater_equal),
    "jnp.less": (torch.lt, torch.less),
    "jnp.less_equal": (torch.le, torch.less_equal),
    "jnp.not_equal": (torch.ne, torch.not_equal),
}

# JNP_SEQUENCE_CASTS
SEQUENCE_CASTS = {
    "jnp.concatenate": (torch.cat, torch.concat, torch.concatenate),
    "jnp.stack": (torch.stack,),
    "jnp.hstack": (torch.hstack,),
    "jnp.vstack": (torch.vstack, torch.row_stack),
}

# (callable, message) pairs that raise under the casts; empty, as the JAX
# package's BANNED_FUNCS
BANNED_FUNCS = []
