from .cipher import PoseidonCipher, MESSAGE_CAPACITY, CIPHER_SIZE
