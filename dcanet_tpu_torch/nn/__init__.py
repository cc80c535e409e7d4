"""Eval-mode building blocks whose parameter names follow the reference's state_dict."""
