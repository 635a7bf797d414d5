"""AdamW (``optimizer``) and the train and eval steps (``train_step``)."""
