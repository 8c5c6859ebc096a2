"""Single-device training: AdamW (``optimizer``) and the train step with
microbatch accumulation (``step``)."""
