from .arpa import read_arpa, write_arpa
from .corpus import clean_sentence, clean_text, convert_numbers_to_words, format_corpus, number_to_words
from .lexicon import PHONE_TO_ID, Lexicon, load_lexicon_file, strip_stress
from .ngram import BOS, EOS, UNK, NGramLM, train_ngram, uniform_unigram
