"""On-device data ops: the ``scaled_sum`` kernel and record decode.

Submodules import torch; this package file imports nothing, so the
package stays importable where torch is absent.
"""
