# Copied from karpenter_tpu/utils/__init__.py.
