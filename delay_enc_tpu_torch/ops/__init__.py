from .limbs import FieldCtx, FR_CTX, FQ_CTX
