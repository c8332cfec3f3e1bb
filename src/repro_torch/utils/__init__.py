"""Tree helpers over nested dicts and lists of tensors (``utils.tree``)."""
