from vitiq.ops.numerics import BF16, Policy, REFERENCE, policy_for  # noqa: F401
from vitiq.ops.attention import scaled_dot_product_attention  # noqa: F401
