"""The LM substrate (dense family): templates, attention, FFN, serving."""
